"""Model zoo of the port: the dense GQA serve path of ``repro/models``."""
