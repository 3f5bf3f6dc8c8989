"""Shadow (``core/shadow.py``): how often the trainer blocked on the
shadow's lag bound, per iteration of the window."""
UNIT, LAYER, MOVES = "waits/step", "shadow", "ckpt_stall_ms"


def read(run):
    if run.shadow is None:
        return None
    a, b = run.shadow["start"], run.shadow["end"]
    return (b["lag_waits"] - a["lag_waits"]) / run.n_iters
