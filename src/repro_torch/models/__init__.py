"""Model zoo of the port: ``repro/models``' ten architectures, their serve
and training paths and the classifier head."""
