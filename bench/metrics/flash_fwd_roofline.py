"""Kernel (``kernels/csrc/flash_attention_wgmma.cu``, and the mma.sync
kernel where the route takes it): the flash forward's share of its
roofline over the window's iterations, %. Each launch is one microbatch of
one layer (the forward and its recompute); its least time is the larger
of its operations at the bf16 peak and its bytes at the HBM rate,
counted at the published head dim and the mask's extent."""
from bench import flops

UNIT, LAYER, MOVES = "%", "kernels", "tokens_per_s"


def read(run):
    if run.profile is None:
        return None
    times = run.profile.kernel_times("flash_fwd_kernel")
    if not times:
        return None
    least = flops.bound_seconds(*flops.flash_launch(run.model, run.traffic))
    return 100.0 * len(times) * least / sum(times)
