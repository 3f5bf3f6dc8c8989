"""The port's figure benchmarks that train models (`repro_torch.benchmarks`:
optimizer_scaling, stalls, throughput, correctness, kernels, and the
runner) against the JAX package's ``benchmarks/`` modules on the CPU.

Both packages start from the reference's ``init_params`` (carried over by
`repro_torch.convert`) at ``bench_config`` sizes or smaller, the JAX
module's constants set to the same cut. What is compared is what does not
depend on the machine: checkpoint counts, stall-stage names, recoveries
and bit-identity, each shadow node's applied state (rtol 1e-6: AdamW's
``b1 ** step`` is taken on the host in the port), losses (rtol 1e-4, the
cross-package tolerance of tests/test_torch_system.py). No test orders
wall times.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

import benchmarks.common as jcommon
import benchmarks.correctness as jcorr
import benchmarks.optimizer_scaling as jopt
import benchmarks.stalls as jstalls
import benchmarks.throughput as jtput
from repro.configs.base import ModelConfig as JModelConfig
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.train.step import make_train_state as j_make_state

from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import correctness as tcorr
from repro_torch.benchmarks import kernels as tkernels
from repro_torch.benchmarks import optimizer_scaling as topt
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import stalls as tstalls
from repro_torch.benchmarks import throughput as ttput
from repro_torch.convert import state_from_numpy

torch.set_num_threads(2)   # leave cores to the other test workers

RULES = ShardingRules(make_smoke_mesh())
# a cut of bench_config small enough for a test, the same in both packages
SMALL = dict(num_layers=1, d_model=128, num_heads=2, num_kv_heads=2,
             head_dim=64, d_ff=256, vocab_size=1024)


def jax_cfg(cfg):
    """The JAX package's ModelConfig with every field of the port's."""
    return JModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def jax_init(cfg, seed, device):
    """The reference's initial state for ``cfg``, carried into the port."""
    js = j_make_state(jax.random.PRNGKey(seed), jax_cfg(cfg), RULES)
    return state_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()},
        {k: np.asarray(v) for k, v in js.mu.items()},
        {k: np.asarray(v) for k, v in js.nu.items()}, int(js.step),
        device=device)


def _capture_train(monkeypatch, module) -> list:
    """Wrap ``module.train`` to record each run's checkpointer and stats."""
    runs, real = [], module.train

    def train(*a, **kw):
        state, stats = real(*a, **kw)
        runs.append((kw.get("checkpointer"), stats))
        return state, stats
    monkeypatch.setattr(module, "train", train)
    return runs


def _rows(capsys) -> list:
    out = capsys.readouterr().out
    return [tuple(line.split(",", 2)) for line in out.splitlines()
            if line and not line.startswith(("#", "name,"))]


def test_bench_config_is_the_references():
    for arch in ("gpt3-xl", "vit-h-14", "arctic-480b", "zamba2-1.2b",
                 "mamba2-2.7b", "whisper-medium"):
        t, j = tcommon.bench_config(arch), jcommon.bench_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
    cut = tcommon.card_config("gpt3-6.7b", 2)
    assert (cut.num_layers, cut.d_model, cut.d_ff, cut.vocab_size) == \
        (2, 4096, 16384, 50257)


def test_optimizer_scaling_applies_what_the_reference_applies(monkeypatch):
    cfg = tcommon.bench_config("gpt3-6.7b", **SMALL)
    jclusters, real = [], jopt.ShadowCluster

    def cluster(*a, **kw):
        c = real(*a, **kw)
        jclusters.append(c)
        return c
    monkeypatch.setattr(jopt, "ShadowCluster", cluster)
    monkeypatch.setattr(jopt, "bench_config",
                        lambda arch, **over: jcommon.bench_config(
                            arch, **SMALL))
    jopt.run()
    tclusters = []
    rows = topt.run("cpu", cfg=cfg, init_state=jax_init, clusters=tclusters)
    assert [r[0] for r in rows] == [f"fig8.nodes{n}" for n in topt.NODES]
    assert len(jclusters) == len(tclusters) == len(topt.NODES)
    for jc, tc in zip(jclusters, tclusters):
        assert [n.bucket_ids for n in tc.nodes] == \
            [n.bucket_ids for n in jc.nodes]
        j, t = jc.consolidate(), tc.consolidate()
        assert t["step"] == j["step"] == 5
        for part in ("params", "mu", "nu"):
            for k in j[part]:
                np.testing.assert_allclose(t[part][k].numpy(),
                                           np.asarray(j[part][k]),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"{part}[{k}]")
        tc.shutdown()


def _systems(runs) -> list:
    return [(type(ck).__name__.replace("Checkpointer", ""),
             ck.n_checkpoints, sorted(ck.stall_stages)) for ck, _ in runs]


def _port_systems(record) -> list:
    names = {"no_checkpoint": "No", "checkmate": "Checkmate", "sync": "Sync",
             "async": "Async", "torch_dcp": "ShardedAsync",
             "gemini": "GeminiLike", "checkfreq": "CheckFreq"}
    return [(names[r["system"]], r["checkpoints"], r["stall_stages"])
            for r in record]


def test_stalls_books_what_the_reference_books(monkeypatch, capsys):
    monkeypatch.setattr(jstalls, "STEPS", 3)
    monkeypatch.setattr(jstalls, "bench_config",
                        lambda arch: jcommon.bench_config(arch, **SMALL))
    jruns = _capture_train(monkeypatch, jstalls)
    jstalls.run()
    jrows = _rows(capsys)
    monkeypatch.setattr(tstalls, "STEPS", 3)
    record = []
    rows = tstalls.run("cpu", cfg=tcommon.bench_config("gpt3-xl", **SMALL),
                       init_state=jax_init, record=record)
    assert [r[0] for r in rows] == [r[0] for r in jrows] == \
        [f"fig2.{s}" for s in tstalls.SYSTEMS]
    assert _port_systems(record) == _systems(jruns)
    assert [r["checkpoints"] for r in record] == [0] + [3] * 5
    for r, (_, stats) in zip(record, jruns):
        assert r["steps_run"] == stats.steps == 3
        np.testing.assert_allclose(r["losses"], stats.losses, rtol=1e-4)


def test_throughput_books_what_the_reference_books(monkeypatch, capsys):
    """The vision model (vit-h-14, a vlm as configured) and one LM, three
    steps: CheckFreq checkpoints its three profiled steps on both packages
    (its tuned frequency, a function of wall times, never applies)."""
    monkeypatch.setattr(jtput, "MODELS", jtput.MODELS[:2])
    monkeypatch.setattr(jtput, "STEPS", 3)
    monkeypatch.setattr(jtput, "bench_config",
                        lambda arch: jcommon.bench_config(arch, **SMALL))
    jruns = _capture_train(monkeypatch, jtput)
    jtput.run()
    jrows = _rows(capsys)
    monkeypatch.setattr(ttput, "STEPS", 3)
    models = [(tcommon.bench_config(a, **SMALL), b, s or 128)
              for a, b, s in ttput.MODELS[:2]]
    record = []
    rows = ttput.run("cpu", models=models, init_state=jax_init,
                     record=record)
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    assert len(rows) == 2 * len(ttput.SYSTEMS)
    assert _port_systems(record) == _systems(jruns)
    assert [r["checkpoints"] for r in record] == \
        [0, 3, 3, 3, 3] * 2
    assert record[0]["family"] == "vlm"          # vit-h-14 as configured


def test_correctness_recovers_bit_identically_as_the_reference(monkeypatch,
                                                               capsys):
    """At f32 compute, where the two packages' losses agree to rtol 1e-4
    (bf16 rounds them apart by about 3e-4)."""
    monkeypatch.setattr(jcorr, "bench_config", lambda arch: jcommon
                        .bench_config(arch, compute_dtype="float32"))
    jruns = _capture_train(monkeypatch, jcorr)
    jcorr.run()
    jrows = _rows(capsys)
    record = {}
    rows = tcorr.run("cpu", init_state=jax_init, record=record,
                     cfg=tcommon.bench_config("vit-h-14",
                                              compute_dtype="float32"))
    assert rows == [(n, 0.0, d) for n, _, d in rows]
    assert [(n, d) for n, _, d in rows] == [(n, d) for n, _, d in jrows]
    assert dict((n, d) for n, _, d in rows) == {
        "fig9.loss_curve_max_diff": "0.00e+00", "fig9.recoveries": "3",
        "fig9.states_bit_identical": "True"}
    assert record["states_bit_identical"] and record["recoveries"] == 3
    assert record["recovered_at"] == jruns[1][1].recovered_at == [2, 4, 7]
    np.testing.assert_allclose(record["losses_a"], jruns[0][1].losses,
                               rtol=1e-4)
    np.testing.assert_allclose(record["losses_b"], jruns[1][1].losses,
                               rtol=1e-4)


def test_embedding_gradient_is_the_same_every_run():
    """The embedding's gradient on the CPU, with repeated tokens and two
    threads, is the same bits every run: the correctness test above (f32
    compute) failed without it, the recovered run's ``embed`` an ulp off,
    because indexing's backward adds repeated rows atomically across
    threads in an order that changes from run to run."""
    from repro_torch.models.layers import embed_tokens
    g = torch.Generator().manual_seed(0)
    embed = torch.randn(4096, 128, generator=g)
    tokens = torch.randint(0, 32, (8, 64), generator=g)
    up = torch.randn(8, 64, 128, generator=g)

    def grad():
        e = embed.clone().requires_grad_(True)
        (embed_tokens(e, tokens, torch.float32) * up).sum().backward()
        return e.grad
    first = grad()
    assert all(torch.equal(first, grad()) for _ in range(20))
    assert torch.equal(embed_tokens(embed, tokens, torch.float32),
                       embed[tokens])


def test_kernels_on_the_cpu_are_the_plain_versions():
    rows = tkernels.run("cpu")
    assert [r[0] for r in rows] == ["kernel.fused_adamw",
                                    "kernel.flash_attention",
                                    "kernel.packed_copy"]
    for _, us, derived in rows:
        assert us > 0 and "max_err=0.0e+00" in derived
    assert "n=65536" in rows[0][2] and "bytes=4194304" in rows[2][2]
    assert "shape=(1, 256, 4, 4, 64) dtype=float32 kernel=plain" in \
        rows[1][2]


def test_runner_keeps_the_references_modules(tmp_path, capsys):
    import benchmarks.run as jrun
    assert [n for n, _ in trun.MODULES] == [
        n for n, _ in jrun.MODULES if n != "roofline_table"]
    assert trun.SMOKE == jrun.SMOKE
    out = tmp_path / "m.json"
    assert trun.main(["--smoke", "--device", "cpu", "--metrics-out",
                      str(out)]) == 0
    text = capsys.readouterr().out
    assert "# FAILURES" not in text and "fig1.best_frequency" in text
    snap = json.loads(out.read_text())
    assert "checkpoint_stall_seconds_total" in json.dumps(snap)


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (tkernels.run, tcorr.run, tstalls.run, ttput.run, topt.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(["--only", "savings"])
