"""Train loop and data (``train/loop.py``, ``data/synthetic.py``): the
mean ``data.batch`` span of the window, ms: the batch drawn on the host
(``SyntheticStream.batch_at``) and placed on the card
(``device_batch``)."""
UNIT, LAYER, MOVES = "ms", "train loop and data", "tokens_per_s"


def read(run):
    xs = run.span_ms("data.batch")
    return sum(xs) / len(xs) if xs else None
