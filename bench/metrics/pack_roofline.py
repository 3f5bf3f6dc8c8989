"""Kernel (``kernels/csrc/bucket_pack.cu``): the capture's bucket pack's
share of its roofline over the window's iterations, %: each gradient
byte read once and written once, at the HBM rate. The capture ends each
iteration, so the window holds all its launches."""
import sys

from bench import flops

UNIT, LAYER, MOVES = "%", "kernels", "ckpt_stall_ms"


def read(run):
    if run.profile is None or not run.n_buckets:
        return None
    times = run.profile.kernel_times("pack_kernel")
    if not times:
        return None
    want = run.n_iters * run.n_buckets
    if len(times) != want:
        print(f"pack_roofline: {len(times)} launches, {want} expected",
              file=sys.stderr)
        return None
    nbytes = run.n_iters * run.n_params * flops.PACK_BYTES
    return 100.0 * nbytes / flops.HBM_BW / sum(times)
