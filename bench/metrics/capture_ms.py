"""Capture (``train/loop.py::Capture``, ``core/buckets.py``,
``core/channel.py::to_host``): the mean ``capture.d2h`` span of the
window, ms: the bucket pack and the copy of every gradient into pinned
host memory, on the trainer's thread."""
UNIT, LAYER, MOVES = "ms", "capture", "ckpt_stall_ms"


def read(run):
    xs = run.span_ms("capture.d2h")
    return sum(xs) / len(xs) if xs else None
