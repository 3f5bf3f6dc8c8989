"""The port's copy-persist baselines against the JAX package's, fed the same
numpy state, and inside the port's training loop.

Tolerance: none. Both packages copy and persist the same bytes, so every
restore(), persisted sink and stage name must be equal bit for bit, and
every stall_total must equal the in-order sum of its stall_stages bit for
bit. The orderings of tests/test_checkpoint_baselines.py are timing bounds
and keep that file's factors.
"""
import io
import time

import numpy as np
import pytest
import torch

import repro.core.channel as jch
import repro.core.checkpoint as jck

from repro_torch import configs as TC
from repro_torch.core import channel as tch
from repro_torch.core import checkpoint as tck
from repro_torch.core.recovery import FailurePlan
from repro_torch.train.loop import TrainingFailure, train

torch.set_num_threads(2)   # leave cores to the other test workers

BASELINES = ("sync", "async", "torch_dcp", "gemini", "checkfreq")


def _np_state(seed=0, n=1 << 14):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal(n).astype(np.float32),
                       "b": rng.standard_normal((3, 5)).astype(np.float32)},
            "mu": {"w": rng.standard_normal(n).astype(np.float32),
                   "b": np.zeros((3, 5), np.float32)},
            "nu": {"w": rng.random(n).astype(np.float32),
                   "b": np.ones((3, 5), np.float32)},
            "step": 1}


def _torch_state(st):
    return {k: ({n: torch.from_numpy(a.copy()) for n, a in v.items()}
                if isinstance(v, dict) else v) for k, v in st.items()}


def _make(pkg, name):
    """One baseline of ``pkg`` (jck or tck); CheckFreq with fixed stalls
    (0.2, 0.3, 0.25 s per profiled checkpoint) so its tuning is a pure
    function of the inputs."""
    if name != "checkfreq":
        return {"sync": pkg.SyncCheckpointer,
                "async": pkg.AsyncCheckpointer,
                "torch_dcp": pkg.ShardedAsyncCheckpointer,
                "gemini": pkg.GeminiLikeCheckpointer}[name](freq=1)
    stalls = iter((0.2, 0.3, 0.25) + (0.01,) * 100)

    class Injected(pkg.CheckFreqCheckpointer):
        def _checkpoint(self, event):
            super()._checkpoint(event)        # the real copy + persist
            return next(stalls)
    return Injected(target_overhead=0.05, profile_steps=3)


def _drive(pkg, ch, ck, state, steps, iter_time=0.5):
    for step in range(1, steps + 1):
        st = dict(state, step=step)
        ck.on_step(ch.StepEvent(step=step, state_fn=lambda st=st: st,
                                iter_time=iter_time))
    ck.finalize()
    return ck


def _ledger_sum(ck) -> float:
    total = 0.0
    for sec in ck.stall_stages.values():
        total += sec
    return total


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_matches_jax(name):
    state = _np_state()
    want = _drive(jck, jch, _make(jck, name), state, 25)
    got = _drive(tck, tch, _make(tck, name), _torch_state(state), 25)
    assert got.n_checkpoints == want.n_checkpoints > 0
    assert list(got.stall_stages) == list(want.stall_stages) == \
        ["copy-persist"]
    assert got.stall_total == _ledger_sum(got)
    a, b = got.restore(), want.restore()
    # checkfreq checkpoints 1, 2, 3, then every 10th step
    assert a["step"] == b["step"] == (20 if name == "checkfreq" else 25)
    for tree in ("params", "mu", "nu"):
        for k, t in a[tree].items():
            assert t.numpy().tobytes() == b[tree][k].tobytes(), (tree, k)
    if name == "gemini":
        assert [t.numpy().tobytes() for t in got._remote] == \
            [x.tobytes() for x in want._remote]
    else:
        assert got._sink.getvalue() == want._sink.getvalue()
    if name == "checkfreq":
        # ceil(mean(0.2, 0.3, 0.25) / (0.05 * 0.5)) = 10
        assert got.tuned_freq == want.tuned_freq == 10


def test_none_books_nothing_and_restores_nothing():
    ck = _drive(tck, tch, tck.NoCheckpointer(), _torch_state(_np_state()), 4)
    assert ck.stall_total == 0.0 and ck.stall_stages == {}
    assert ck.n_checkpoints == 0 and ck.restore() is None


def test_persist_writes_bf16_bytes():
    t = torch.randn(7).to(torch.bfloat16)
    sink = io.BytesIO()
    tck._persist([t, torch.as_tensor(3)], sink)
    assert sink.getvalue() == (t.view(torch.int16).numpy().tobytes()
                               + np.int64(3).tobytes())


# -- the orderings of tests/test_checkpoint_baselines.py --------------------

def _big(nbytes=8 << 20):
    return _torch_state(_np_state(n=nbytes // 4))


def _train_like(ck, state, steps=6, step_s=0.05):
    """Drive ``ck`` with a step of ``step_s`` seconds between checkpoints,
    the time a background persist is meant to overlap."""
    for step in range(1, steps + 1):
        time.sleep(step_s)
        st = dict(state, step=step)
        ck.on_step(tch.StepEvent(step=step, state_fn=lambda st=st: st,
                                 iter_time=step_s))
    ck.finalize()
    return ck


def test_sync_stalls_most():
    state = _big()
    sync = _train_like(tck.SyncCheckpointer(freq=1), state)
    async_ = _train_like(tck.AsyncCheckpointer(freq=1), state)
    sharded = _train_like(tck.ShardedAsyncCheckpointer(freq=1, n_shards=8),
                          state)
    assert sync.n_checkpoints == 6
    assert sync.stall_total >= async_.stall_total * 0.8
    assert async_.stall_total >= sharded.stall_total * 0.5
    assert sync.restore()["step"] == 6


def test_frequency_trades_stall():
    state = _big()
    every = _drive(tck, tch, tck.SyncCheckpointer(freq=1), state, 6, 0.01)
    sparse = _drive(tck, tch, tck.SyncCheckpointer(freq=5), state, 6, 0.01)
    assert sparse.n_checkpoints < every.n_checkpoints
    assert sparse.stall_total < every.stall_total


def test_gemini_overlap_model():
    ck = tck.GeminiLikeCheckpointer(freq=1, network_gbps=0.5)
    st = _big()
    s_long = ck.on_step(tch.StepEvent(step=1, state_fn=lambda: st,
                                      iter_time=2.0))
    s_short = ck.on_step(tch.StepEvent(step=2, state_fn=lambda: st,
                                       iter_time=0.0001))
    assert s_short >= s_long + 0.05


@pytest.mark.parametrize("stalls,want", [((0.2, 0.3, 0.25), 10),
                                         ((0.001, 0.002, 0.003), 1),
                                         ((1.0, 1.0, 1.0), 40)])
def test_checkfreq_tunes_like_jax_on_injected_stalls(stalls, want):
    """The tuned frequency from injected profiled stalls, against JAX's."""
    freqs = []
    for pkg, ch in ((jck, jch), (tck, tch)):
        it = iter(stalls)

        class Injected(pkg.CheckFreqCheckpointer):
            def _checkpoint(self, event):
                return next(it, 0.01)
        ck = Injected(target_overhead=0.05, profile_steps=3)
        for step in range(1, 10):
            ck.on_step(ch.StepEvent(step=step, iter_time=0.5))
        freqs.append((ck.tuned_freq, ck.n_checkpoints))
    assert freqs[0] == freqs[1]
    assert freqs[1][0] == want


# -- inside the training loop ----------------------------------------------

def _cfg():
    return TC.get("tinyllama-1.1b").reduced()


@pytest.mark.parametrize("name", BASELINES[:4])
def test_train_with_a_failure_ends_at_the_uninterrupted_state(name):
    cfg = _cfg()
    ref, _ = train(cfg, steps=5, batch=2, seq=16, seed=3, device="cpu")
    ck = _make(tck, name)
    state, stats = train(cfg, steps=5, batch=2, seq=16, seed=3,
                         checkpointer=ck, failure_plan=FailurePlan((3,)),
                         device="cpu")
    assert stats.recoveries == 1 and stats.recovered_at == [2]
    assert ck.n_checkpoints == 5              # 1, 2, then 3, 4, 5 again
    assert ck.stall_total == _ledger_sum(ck)
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(ref, tree).items():
            assert torch.equal(getattr(state, tree)[k], t), (tree, k)
    latest = ck.restore()
    assert latest["step"] == 5
    for k, t in state.params.items():
        assert torch.equal(latest["params"][k], t)


def test_a_failure_without_a_checkpoint_raises():
    with pytest.raises(TrainingFailure):
        train(_cfg(), steps=3, batch=2, seq=16, device="cpu",
              failure_plan=FailurePlan((2,)))
