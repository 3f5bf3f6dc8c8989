"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU at reduced size: every checkpointer recovers from two injected
failures, and the report has the JAX CLI's keys.

No numeric tolerance: the checks are counts (recoveries, checkpoints), key
sets, and for ``--optimizer adam|sgd`` the shadow bitwise the trainer.
"""
import json
import sys

import pytest
import torch

from repro_torch.launch import train as launch
from repro_torch.train.loop import TrainingFailure

torch.set_num_threads(2)   # leave cores to the other test workers

BASE = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
        "--seq", "16"]
RUNS = {
    "checkmate": ["--checkpointer", "checkmate"],
    "checkmate --compress": ["--checkpointer", "checkmate", "--compress"],
    "checkmate --shadow-async": ["--checkpointer", "checkmate",
                                 "--shadow-async", "--max-lag-steps", "2"],
    "checkmate --channel packetized": [
        "--checkpointer", "checkmate", "--channel", "packetized",
        "--shadow-async", "--max-lag-steps", "2"],
    "checkmate --channel packetized --compress": [
        "--checkpointer", "checkmate", "--channel", "packetized",
        "--topology", "leaf-spine", "--compress"],
    **{name: ["--checkpointer", name]
       for name in ("sync", "async", "torch_dcp", "gemini", "checkfreq")},
}


@pytest.fixture(scope="module")
def jax_report_keys():
    """The JAX CLI's report keys, from one small run of it."""
    import io
    from contextlib import redirect_stdout

    from repro.launch import train as jlaunch
    argv = ["repro.launch.train", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "16", "--checkpointer", "checkmate", "--fail-at",
            "2"]
    out = io.StringIO()
    saved = sys.argv
    try:
        sys.argv = argv
        with redirect_stdout(out):
            jlaunch.main()
    finally:
        sys.argv = saved
    text = out.getvalue()
    report, _ = json.JSONDecoder().raw_decode(text[text.index("{"):])
    return report


@pytest.mark.parametrize("run", list(RUNS))
def test_every_checkpointer_recovers_twice(run, jax_report_keys, capsys):
    report = launch.main(BASE + RUNS[run] + ["--fail-at", "3,5"])
    out = capsys.readouterr().out
    assert json.JSONDecoder().raw_decode(out)[0] == report
    assert "== run digest ==" in out
    assert report["failures"] == report["recoveries"] == 2
    # checkfreq's tuned frequency (from measured stalls) may skip step 4's
    # checkpoint, and the failure at 5 then replays step 4 too
    assert report["steps"] >= 6 and report["checkpoints"] >= 3
    checkmate = run.startswith("checkmate")
    want = set(jax_report_keys)
    if not checkmate:
        want -= {"channel", "shadow", "gated_steps"}
    assert set(report) == want
    if checkmate:
        assert set(report["shadow"]) == set(jax_report_keys["shadow"])
        assert report["shadow"]["lag"] == 0
        base = "packetized" if "packetized" in run else "inprocess"
        assert report["channel"] == (f"compressed[{base}]"
                                     if "--compress" in run else base)


@pytest.mark.parametrize("arch", ["granite-34b", "arctic-480b",
                                  "mamba2-2.7b", "zamba2-1.2b",
                                  "whisper-medium", "llava-next-mistral-7b"])
def test_every_family_runs_through_the_driver(arch, jax_report_keys,
                                              capsys):
    """One arch per family reachable by ``--arch`` (dense gelu2, moe, ssm,
    hybrid, audio, vlm) at ``--reduced --device cpu``: the JAX CLI's report
    keys, one recovery with no step lost, and the shadow bitwise the
    trainer."""
    r = launch.run(["--arch", arch] + BASE + [
        "--checkpointer", "checkmate", "--steps", "4", "--fail-at", "3"])
    rep = r.report
    assert set(rep) == set(jax_report_keys)
    assert rep["arch"] == f"{arch}-smoke"
    assert rep["recoveries"] == 1 and r.stats.recovered_at == [2]
    assert rep["shadow"]["lag"] == 0 and rep["checkpoints"] == 4
    ckpt = r.checkpointer.shadow.consolidate()
    assert ckpt["step"] == r.state.step == 4
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(r.state, tree).items():
            assert torch.equal(ckpt[tree][k], t), f"{tree}[{k}]"


def test_none_runs_and_cannot_recover():
    r = launch.run(BASE + ["--checkpointer", "none", "--steps", "3"])
    assert r.report["checkpoints"] == 0 and r.report["stall_total_s"] == 0.0
    with pytest.raises(TrainingFailure):
        launch.run(BASE + ["--checkpointer", "none", "--fail-at", "3,5"])


def test_run_exposes_what_it_drove():
    r = launch.run(BASE + ["--checkpointer", "sync", "--steps", "3",
                           "--fail-at", "2"])
    latest = r.checkpointer.restore()
    assert latest["step"] == r.state.step == 3
    for k, t in r.state.params.items():
        assert torch.equal(latest["params"][k], t)
    assert r.stats.recovered_at == [1]
    assert r.snapshot["metrics"]["checkpoints_total"]["samples"]


def test_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run(["--reduced", "--steps", "1"])


def test_other_optimizers_are_refused():
    with pytest.raises(ValueError, match="lion"):
        launch.run(BASE + ["--optimizer", "lion"])


def test_layers_cuts_the_depth():
    r = launch.run(BASE + ["--layers", "1", "--steps", "2"])
    assert r.state.params["wq"].shape[0] == 1
    assert r.checkpointer.shadow.consolidate()["step"] == 2


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_adam_and_sgd_run_through_the_driver(optimizer):
    """``--optimizer adam|sgd``: the run recovers from a failure and the
    shadow ends bitwise the trainer's state."""
    r = launch.run(BASE + ["--optimizer", optimizer, "--checkpointer",
                           "checkmate", "--steps", "4", "--fail-at", "3"])
    assert r.report["recoveries"] == 1 and r.report["shadow"]["lag"] == 0
    assert r.checkpointer.shadow.opt.name == optimizer
    ckpt = r.checkpointer.shadow.consolidate()
    assert ckpt["step"] == r.state.step == 4
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(r.state, tree).items():
            assert torch.equal(ckpt[tree][k], t), f"{tree}[{k}]"
