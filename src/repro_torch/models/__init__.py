"""Model families (the port of ``repro.models``; dense so far)."""
