"""Distributed pieces of the port (the port of ``repro.dist``): so far the
int8 + error-feedback gradient codec."""
