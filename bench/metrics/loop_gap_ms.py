"""Train loop and data (``train/loop.py``, ``data/synthetic.py``): the
window's seconds per iteration less its ``step.compute``, ``capture.d2h``
and ``checkpoint.on_step`` spans, ms; mostly the batch drawn on the host
and placed on the card."""
UNIT, LAYER, MOVES = "ms", "train loop and data", "tokens_per_s"

SPANS = ("step.compute", "capture.d2h", "checkpoint.on_step")


def read(run):
    if not run.span_ms("step.compute"):
        return None
    inside = sum(sum(run.span_ms(name)) for name in SPANS)
    return (run.window_s * 1e3 - inside) / run.n_iters
