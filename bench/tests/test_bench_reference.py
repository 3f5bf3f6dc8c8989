"""The reference against the port's ``train`` on the CPU, and the check
that decides ``correct``: a sound run passes, and a run with its timed
path broken underneath fails, once for each fault a training cell can
have. The runs go through the harness's own ``run_cell`` at a CPU size
(``conftest.tiny_cell``), skipping only its look for a card."""
import pytest
import torch
from conftest import tiny_cell

from bench import compare, harness
from bench.reference.model import train_reference

SEED = 2**31 + 977


def run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.3, trace, device="cpu")


@pytest.mark.parametrize("name", ["gpt2-1.5b.checkmate", "gpt2-1.5b.none",
                                  "vit-h-14.checkmate"])
def test_bench_reference_matches_the_port_at_f32(name):
    out = run(tiny_cell(name))
    assert out["correct"], out["checks"]
    for k, c in out["checks"].items():
        assert c["value"] <= (0 if k == "shadow_mismatch" else 1e-5), k
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {"tokens_per_s", "mfu", "peak_hbm_gb", "setup_s"}
    if name.endswith("checkmate"):
        names.add("ckpt_stall_ms")
    assert set(out["metrics"]) == names


def test_bench_traced_run_reads_the_spans():
    out = run(tiny_cell(), trace=True)
    assert out["correct"]
    m = out["metrics"]
    for k in ("step_ms", "loop_gap_ms", "capture_ms", "on_step_ms",
              "shadow_apply_ms", "lag_waits_per_step", "step_mfu"):
        assert k in m, k
    assert "device_idle" not in m          # no device trace on the CPU


def test_bench_window_runs_the_step_set_up_checked(monkeypatch):
    """The compared steps 1-3 and the window's iterations are calls of one
    step function, built once, in one call of the loop: the window runs
    the path that the check saw."""
    import repro_torch.train.loop as loop
    built, calls = [], []
    real = loop.build_train_step

    def build(cfg, opt, lr_fn, rules=None):
        step = real(cfg, opt, lr_fn, rules)

        def counted(state, batch):
            calls.append(len(built))
            return step(state, batch)
        built.append(counted)
        return counted
    monkeypatch.setattr(loop, "build_train_step", build)
    cell = tiny_cell()
    out = run(cell)
    assert out["correct"], out["checks"]
    assert len(built) == 1
    warmup = cell.traffic["warmup_steps"]
    assert calls == [1] * (warmup + out["attempted"])


def _unchanged(real):
    def build(cfg, opt, lr_fn, rules=None):
        step = real(cfg, opt, lr_fn, rules)

        def frozen(state, batch):
            import copy
            _, metrics, grads = step(copy.deepcopy(state), batch)
            return state, metrics, grads
        return frozen
    return build


def _half_batch(real):
    def build(cfg, opt, lr_fn, rules=None):
        step = real(cfg, opt, lr_fn, rules)

        def half(state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    return build


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange",
                                   "altered_gradient"])
@pytest.mark.parametrize("name", ["gpt2-1.5b.checkmate", "gpt2-1.5b.none"])
def test_bench_broken_run_is_not_correct(monkeypatch, name, fault):
    import repro_torch.train.loop as loop
    from repro_torch.core.channel import InProcessChannel
    if name.endswith("none") and fault in ("no_exchange",
                                           "altered_gradient"):
        pytest.skip("no exchange and no captured answer without a "
                    "checkpointer")
    if fault == "unchanged":
        monkeypatch.setattr(loop, "build_train_step",
                            _unchanged(loop.build_train_step))
    elif fault == "half_batch":
        monkeypatch.setattr(loop, "build_train_step",
                            _half_batch(loop.build_train_step))
    elif fault == "no_exchange":
        monkeypatch.setattr(InProcessChannel, "poll", lambda self: [])
    else:
        real = loop.Capture.__call__

        def altered(self, grads):
            flats = real(self, grads)
            first = flats[min(flats)]
            first.view(-1)[0] += 1.0
            return flats
        monkeypatch.setattr(loop.Capture, "__call__", altered)
    out = run(tiny_cell(name))
    assert not out["correct"], out["checks"]


def test_bench_control_reads_above_the_program():
    """The control (the reference in float8) and the planted faults read
    far above the program in bf16, at a size a test run holds."""
    cell = tiny_cell(compute_dtype="bfloat16")
    model = cell.config["model"]
    tr = dict(cell.traffic, batch=8, seq=32)
    cell.traffic = tr
    ref = train_reference(model, tr, SEED, "cpu")
    prog = run(cell)["checks"]
    fp8 = compare.numbers(train_reference(model, tr, SEED, "cpu",
                                          precision="fp8"), ref)
    half = compare.numbers(train_reference(model, tr, SEED, "cpu",
                                           rows="half"), ref)
    assert fp8["grad_err"] > 3 * prog["grad_err"]["value"]
    assert half["grad_gap"] > 10 * prog["grad_gap"]["value"]
    unchanged = compare.numbers(train_reference(model, tr, SEED, "cpu",
                                                update=False), ref)
    assert unchanged["grad_gap"] == unchanged["change_gap"] == 1.0


def test_bench_fp8_matmul_rounds_both_ways():
    from bench.reference.model import _Fp8MatMul
    a = torch.randn(3, 5, dtype=torch.float64, requires_grad=True)
    b = torch.randn(5, 4, dtype=torch.float64, requires_grad=True)
    y = _Fp8MatMul.apply(a, b)
    assert 0 < (y - a @ b).abs().max() < 0.5
    y.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape


@pytest.mark.chip
def test_bench_cell_on_the_card(chip, tmp_path):
    """A short run of each cell on the card comes out correct."""
    import json
    import subprocess
    import sys

    from bench import spec
    for cell in [w["name"] for w in spec.load_benchmark()["workloads"]]:
        out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                              cell, "--seed", "31", "--seconds", "5",
                              "--trace", "0"], cwd=spec.ROOT,
                             capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1])["correct"]
