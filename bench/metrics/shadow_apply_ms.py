"""Shadow (``core/shadow.py``): the mean wall time of one node's apply of
one step over the window, ms, from the nodes' apply counters at the
window's two ends (an apply synchronizes its own stream)."""
UNIT, LAYER, MOVES = "ms", "shadow", "ckpt_stall_ms"


def read(run):
    if run.shadow is None:
        return None
    a, b = run.shadow["start"], run.shadow["end"]
    n = b["apply_count"] - a["apply_count"]
    return 1e3 * (b["apply_total_s"] - a["apply_total_s"]) / n if n else None
