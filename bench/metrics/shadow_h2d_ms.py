"""Shadow (``core/shadow.py``, its staged copies): the device time of one
node's copies of one step's gradients onto the card, ms, per apply over
the window (``bench/shadow_ops.py``): the PCIe side of
``shadow_apply_ms``."""
from bench.shadow_ops import per_apply_ms

UNIT, LAYER, MOVES = "ms", "shadow", "ckpt_stall_ms"


def read(run):
    return per_apply_ms(run, copies=True)
