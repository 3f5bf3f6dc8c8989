"""The comparison that decides ``correct``: the numbers the program's run
is judged by, each against its limit.

A training cell follows the reference through the first three steps of
the run, the steps set-up drives through the window's own loop, and
compares:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as the optimizer took it, by the worst
  leaf: the gap between the program's norm of that leaf and the
  reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger;
- ``grad_err``: the first gradient element by element, at indices
  drawn from the seed (`reference.inputs.probe_indices`), by the worst
  leaf: the norm of the difference of the two samples over the norm of
  the reference's sample of that leaf or of the median leaf, whichever is
  larger. The gaps of norms above move with an error only to its second
  order where the error is random; this moves to its first, and it is
  the number a lower precision fails (the control);
- ``change_gap``: the same as ``grad_gap`` of each leaf's change after the three steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves those by round-off alone);
- ``shadow_mismatch`` (a cell with Checkmate): the elements, and the step,
  in which the checkpoint the shadow consolidates once the window has
  closed differs bit for bit from the trainer's state.

A number passes when it is at most its limit (``bench/limits/<cell>
.json``).
"""
from __future__ import annotations

import statistics

NEGLIGIBLE_GRAD = 1e-3


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """Each leaf's gap between two per-leaf norms, relative to the
    reference's norm of that leaf or of the median leaf."""
    names = sorted(ref) if leaves is None else leaves
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def moved_leaves(ref: dict) -> list:
    """The leaves whose reference gradient is not negligible."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    return [k for k in sorted(g) if g[k] >= NEGLIGIBLE_GRAD * med]


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf that sets ``grad_gap`` and the one that sets
    ``change_gap``, for the run's log."""
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"],
                       moved_leaves(ref))
    return {"grad_gap": max(grad, key=grad.get),
            "change_gap": max(change, key=change.get)}


def probe_err(prog: dict, ref: dict) -> float:
    """``grad_err`` from the two sides' probed first gradients."""
    ref_norm = {k: float(v.norm()) for k, v in ref.items()}
    med = statistics.median(ref_norm.values())
    return max(float((prog[k] - ref[k]).norm()) / max(ref_norm[k], med)
               for k in ref)


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers from the program's readings and the
    reference's, each ``{"losses", "grad_norms", "grad_probe",
    "change_norms"}``."""
    if sorted(prog["grad_norms"]) != sorted(ref["grad_norms"]):
        raise ValueError("the program and the reference have other leaves")
    n = len(ref["losses"])
    if len(prog["losses"]) < n:
        raise ValueError(f"the program ran {len(prog['losses'])} steps of "
                         f"the {n} compared")
    loss = max(abs(p - r) / abs(r)
               for p, r in zip(prog["losses"][:n], ref["losses"]))
    return {"loss_gap": loss,
            "grad_gap": max(leaf_gaps(prog["grad_norms"],
                                      ref["grad_norms"]).values()),
            "grad_err": probe_err(prog["grad_probe"], ref["grad_probe"]),
            "change_gap": max(leaf_gaps(prog["change_norms"],
                                        ref["change_norms"],
                                        moved_leaves(ref)).values())}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number at most its
    limit; a number without a limit, or a limit without its number,
    fails."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in values.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok and set(values) == set(limits), checks
