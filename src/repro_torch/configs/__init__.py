"""Architecture configs: the port's copy of ``repro/configs``."""
