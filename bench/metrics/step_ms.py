"""Train step (``train/step.py``, ``models/*``): the mean ``step.compute``
span of the window, ms. The span ends when the loop reads the loss on the
host, which waits for all the step's queued work, the optimizer's
update included."""
UNIT, LAYER, MOVES = "ms", "train step", "tokens_per_s"


def read(run):
    xs = run.span_ms("step.compute")
    return sum(xs) / len(xs) if xs else None
