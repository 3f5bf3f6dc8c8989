"""Checkpointer and channel (``core/checkpoint.py``,
``core/channel.py``): the mean ``checkpoint.on_step`` span of the window,
ms, waits on the shadow's lag bound included."""
UNIT, LAYER, MOVES = "ms", "checkpointer and channel", "ckpt_stall_ms"


def read(run):
    xs = run.span_ms("checkpoint.on_step")
    return sum(xs) / len(xs) if xs else None
