"""``flash_bwd_roofline``: the backward's bound at the benchmark's own
shapes, and its reading of a trace with and without the kernel."""
import pytest

from bench import flops, spec, trace
from bench.harness import Run

METRIC = spec.reader("flash_bwd_roofline")


def _run(cell, profile=None):
    c = spec.load_cell(cell)
    return Run(model=c.config["model"], traffic=c.traffic, window_s=1.0,
               first_step=1, last_step=1, capture_times=[], stall_times=[],
               profile=profile)


def test_bench_flash_bwd_bound_at_the_cells_shapes():
    # gpt2-1.5b: 4 x 1024 a microbatch, 25 heads of 64, causal
    run = _run("gpt2-1.5b.none")
    ops, nbytes = METRIC.launch_work(run.model, run.traffic)
    assert ops == 10 * 4 * 25 * 64 * (1024 * 1025 // 2)
    assert ops == pytest.approx(3.36e10, rel=1e-3)
    assert nbytes == 2 * 4 * 1024 * 64 * 8 * 25 + 8 * 4 * 25 * 1024
    assert nbytes == pytest.approx(105.7e6, rel=1e-3)
    assert flops.bound_seconds(ops, nbytes) == pytest.approx(34e-6, rel=0.01)
    # vit-h-14: 32 x 256 patches a microbatch, 16 heads of 80, no mask;
    # the bytes bound it
    run = _run("vit-h-14.checkmate")
    ops, nbytes = METRIC.launch_work(run.model, run.traffic)
    assert ops == 10 * 32 * 16 * 80 * 256 * 256
    assert nbytes == 2 * 32 * 256 * 80 * 8 * 16 + 8 * 32 * 16 * 256
    assert nbytes / flops.HBM_BW > ops / flops.PEAK_BF16
    assert flops.bound_seconds(ops, nbytes) == pytest.approx(50e-6, rel=0.01)


def _profile(kernels):
    spin = "spin_kernel"
    return trace.Profile(0.0, 1.0, kernels=[(spin, 0.0, 0.0, 7)] + kernels,
                         marks=[0.0, 1.0], main_stream=7)


def test_bench_flash_bwd_reads_one_backward_a_dkdv_launch():
    assert METRIC.read(_run("gpt2-1.5b.none")) is None       # no profile
    # the parent's program: no backward kernel, and the forward's kernel
    # is not read
    fwd = ("void (anonymous namespace)::flash_fwd_kernel_wgmma<64>", 0.1,
           0.2, 7)
    assert METRIC.read(_run("gpt2-1.5b.none", _profile([fwd]))) is None
    run = _run("gpt2-1.5b.none")
    least = flops.bound_seconds(*METRIC.launch_work(run.model, run.traffic))
    ns = "void (anonymous namespace)::"
    one = [(ns + "flash_bwd_delta_kernel", 0.0, 10e-6, 7),
           (ns + "flash_bwd_dkdv_kernel_wgmma<64>", 0.0, 60e-6, 7),
           (ns + "flash_bwd_dq_kernel_wgmma<64>", 0.0, 30e-6, 7)]
    got = METRIC.read(_run("gpt2-1.5b.none", _profile([fwd] + one + one)))
    assert got == pytest.approx(100.0 * 2 * least / 200e-6)
