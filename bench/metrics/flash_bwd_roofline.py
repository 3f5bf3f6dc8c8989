"""Kernel (``kernels/csrc/flash_attention_bwd.cu``): the flash backward's
share of its roofline over the window's iterations, %. Each launch of its
dK/dV kernel is one backward (one microbatch of one layer), made of the
``flash_bwd*`` kernels (delta, dK/dV, dQ), whose summed time is its time.
Its least time is the larger of its operations at the bf16 peak and its
bytes at the HBM rate: five products (2.5 times the forward's two), at the
published head dim and the mask's extent; q, k, v, o and do read and dq,
dk and dv written in bf16, lse and delta read in f32. A program without
the kernel (the plain PyTorch backward) reads nothing."""
from bench import flops

UNIT, LAYER, MOVES = "%", "kernels", "tokens_per_s"


def launch_work(model: dict, traffic: dict) -> tuple[float, float]:
    """(operations, bytes) of one backward launch."""
    b = traffic["batch"] // traffic["microbatches"]
    s = flops.tokens_per_row(model, traffic)
    h, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    ops = 2.5 * flops.flash_launch(model, traffic)[0]
    nbytes = 2.0 * b * s * hd * (4 * h + 4 * kv) + 8.0 * b * h * s
    return ops, nbytes


def read(run):
    if run.profile is None:
        return None
    launches = run.profile.kernel_times("flash_bwd_dkdv")
    times = run.profile.kernel_times("flash_bwd")
    if not launches:
        return None
    least = flops.bound_seconds(*launch_work(run.model, run.traffic))
    return 100.0 * len(launches) * least / sum(times)
