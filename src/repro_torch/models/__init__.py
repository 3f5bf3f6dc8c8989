"""Model families, the port of ``repro.models``' training paths."""
