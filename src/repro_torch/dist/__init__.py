"""Distributed pieces of the port (the port of ``repro.dist``): the int8 +
error-feedback gradient codec, the logical-axis sharding rules, and the
explicit ring RS+AG and GPipe schedules over ``torch.distributed``."""
