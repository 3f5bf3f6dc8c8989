"""Kernel (``kernels/csrc/fused_adamw.cu``): the fused AdamW's share of
its roofline over the window's iterations, %: the trainer's launches,
one a leaf on the stream the harness's markers ran on, each element's p,
m, v read and written and g read in f32, at the HBM rate. The shadow's
launches of the same kernel run on its own streams a lag behind, so a
window holds parts of its applies, whose sizes the trace does not give:
they are left out. Another launch count reads nothing."""
import sys

from bench import flops

UNIT, LAYER, MOVES = "%", "kernels", "tokens_per_s"


def read(run):
    if run.profile is None:
        return None
    times = run.profile.kernel_times("adamw_kernel",
                                     stream=run.profile.main_stream)
    if not times:
        return None
    want = run.n_iters * run.n_leaves
    if len(times) != want:
        print(f"adamw_roofline: {len(times)} launches, {want} expected",
              file=sys.stderr)
        return None
    nbytes = run.n_iters * run.n_params * flops.ADAMW_BYTES
    return 100.0 * nbytes / flops.HBM_BW / sum(times)
