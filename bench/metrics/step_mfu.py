"""Train step (``train/step.py``, ``models/*``): the step's share of the
card's bf16 peak, %: the step's model FLOPs (``flops.step_model_flops``,
no recompute) over the mean ``step.compute`` span. It bounds every
kernel's gain on the step: a kernel taken off the path leaves its own
roofline silent, and this share still reads."""
from bench import flops

UNIT, LAYER, MOVES = "%", "train step", "tokens_per_s"


def read(run):
    xs = run.span_ms("step.compute")
    if not xs:
        return None
    step_s = sum(xs) / len(xs) / 1e3
    return 100.0 * flops.step_model_flops(run.model, run.traffic) \
        / step_s / flops.PEAK_BF16
