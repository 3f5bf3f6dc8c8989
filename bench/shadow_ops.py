"""The shadow's device time in a window's trace, per apply of one node.

The shadow's nodes are the only users of streams other than the one the
harness's markers ran on: each node updates on a stream of its own and
copies the gradients onto the card on another. So their operations are
told by stream, each stream's time is the union of its operations'
intervals clipped to the window, and the applies are counted by the
nodes' counters at the window's two ends (an apply in flight at an end
is counted at most once, its device time in part)."""
from bench.trace import union_s


def per_apply_ms(run, copies: bool):
    """Mean device ms per apply of the nodes' copies onto the card
    (``copies``) or of their kernels; None without a trace or a shadow."""
    p = run.profile
    if p is None or run.shadow is None:
        return None
    n = run.shadow["end"]["apply_count"] - run.shadow["start"]["apply_count"]
    ops = ([op for op in p.copies if "HtoD" in op[0]] if copies
           else p.kernels)
    by_stream = {}
    for _, a, b, st in ops:
        if st != p.main_stream and b > p.start and a < p.end:
            by_stream.setdefault(st, []).append((max(a, p.start),
                                                 min(b, p.end)))
    if n <= 0 or not by_stream:
        return None
    return 1e3 * sum(union_s(iv) for iv in by_stream.values()) / n
