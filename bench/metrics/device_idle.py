"""Device: the share of the window's wall time in which no
kernel or copy ran on any stream, %. The busy time is the union of the
device intervals (``trace.union_s``, a copy of ``tools/profile_port.py``'s
arithmetic)."""
UNIT, LAYER, MOVES = "%", "device", "tokens_per_s"


def read(run):
    if run.profile is None or run.profile.wall_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s() / run.profile.wall_s)
