"""Shadow (``core/shadow.py``, ``kernels/csrc/fused_adamw.cu``): the
device time of one node's kernels for one step, ms, per apply over the
window (``bench/shadow_ops.py``): the HBM side of ``shadow_apply_ms``."""
from bench.shadow_ops import per_apply_ms

UNIT, LAYER, MOVES = "ms", "shadow", "ckpt_stall_ms"


def read(run):
    return per_apply_ms(run, copies=False)
