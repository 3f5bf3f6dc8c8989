"""Checkmate's core: buckets, channel, shadow cluster, checkpointer and
recovery (the port of ``repro.core``)."""
