"""Tensor-parallel training over a (2, 2) ("data", "model") mesh of four
gloo ranks on the CPU against the reference's GSPMD step on four forced
host devices.

The reference runs once, in a module-scoped subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, and dumps to an
``.npz`` its initial params, each step's loss and gathered gradients, the
final state and each device's ``addressable_shards`` of it, at f32
compute, 2 microbatches, 3 steps, on six ``.reduced()`` cases: tinyllama
as it is (every cut on whole heads), with one kv head (``wk``/``wv`` cut
inside it, gathered), with 3 heads and one kv head (the sequence-sharded
attention, ``wq`` cut at 1.5 heads), with a vocab of 255 (the vocab
whole), granite-34b (gelu2, under its FSDP) and llava-next-mistral-7b
(the vlm). The port runs once on four gloo ranks
(``tests/_torch_tp_workers.py::tp_train``) from the reference's params
carried over by ``repro_torch.convert``; each rank dumps what it saw.

Tolerances are tests/test_torch_dp_train.py's: losses and gradients to
rtol 1e-4 / atol 1e-6, states to rtol 1e-5 / atol 1e-6, with AdamW at
eps 1e-4 in both packages (``_torch_tp_workers.EPS`` says why). Inside
the port the trainer and its shadow are compared bit for bit, each step
is captured once, and the (2, 2) run's checkpoint is restored onto (4, 1)
and (1, 4).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_spawn import spawn
from _torch_tp_workers import CASES, EPS, STEPS

torch.set_num_threads(2)   # leave cores to the other test workers

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
LOSS = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-5, atol=1e-6)

REFERENCE = """
import sys
import numpy as np, jax
from repro.dist import compat
import repro.configs as C
from repro.data.synthetic import SyntheticStream, device_batch
from repro.dist.sharding import ShardingRules
from repro.optim import OptimizerConfig
from repro.train.step import build_train_step, make_train_state

out = {}
OPT = OptimizerConfig(lr=1e-3, eps=%r, grad_clip=0.5)
m = compat.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(compat.AxisType.Auto,) * 2)
assert [d.id for d in m.devices.flat] == [0, 1, 2, 3]
for tag, (arch, over) in %r.items():
    cfg = C.get(arch).reduced(compute_dtype="float32", microbatches=2,
                              **over)
    rules = ShardingRules(m, fsdp=cfg.fsdp)
    state = make_train_state(jax.random.PRNGKey(0), cfg, rules)
    for k, v in state.params.items():
        out[f"{tag}/init/{k}"] = np.asarray(v)
    step = jax.jit(build_train_step(cfg, m, rules, OPT, lambda s: 1e-3))
    stream = SyntheticStream(cfg, 16, 16, seed=0)
    with m:
        for t in range(%d):
            state, met, g = step(state, device_batch(stream.batch_at(t),
                                                     rules))
            out[f"{tag}/loss/{t}"] = np.asarray(met["loss"])
            out[f"{tag}/gnorm/{t}"] = np.asarray(met["grad_norm"])
            for k, v in g.items():
                out[f"{tag}/grad/{t}/{k}"] = np.asarray(v)
    for tree in ("params", "mu", "nu"):
        for k, v in getattr(state, tree).items():
            out[f"{tag}/{tree}/{k}"] = np.asarray(v)
            for s in v.addressable_shards:
                out[f"{tag}/shard/{tree}/{k}/{s.device.id}"] = \\
                    np.asarray(s.data)
np.savez(sys.argv[1], **out)
""" % (EPS, CASES, STEPS)


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          path], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    return dict(np.load(ref_path))


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    """What each of the four ranks saw (``tp_train``'s dumps)."""
    d = tmp_path_factory.mktemp("ranks")
    spawn("_torch_tp_workers", "tp_train", WORLD, d, ref_path, str(d),
          timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _close(got, want, what, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **tol)


@pytest.mark.parametrize("tag", list(CASES))
def test_two_by_two_matches_the_reference_step(ref, ranks, tag):
    """Each rank's loss, grad norm (each element of the global tree
    counted once over the mesh: the clip binds, so the update depends on
    it), the gathered reduced gradients and the final state against the
    reference's GSPMD step on the same mesh."""
    for out in ranks:
        for t in range(STEPS):
            assert out[f"{tag}/loss/{t}"] == pytest.approx(
                float(ref[f"{tag}/loss/{t}"]), rel=LOSS["rtol"])
            gnorm = float(ref[f"{tag}/gnorm/{t}"])
            assert gnorm > 0.5
            assert out[f"{tag}/gnorm/{t}"] == pytest.approx(
                gnorm, rel=LOSS["rtol"])
            grads = out[f"{tag}/grad/{t}"]
            assert set(grads) == {k.split("/")[-1] for k in ref
                                  if k.startswith(f"{tag}/grad/{t}/")}
            for k, g in grads.items():
                _close(g, ref[f"{tag}/grad/{t}/{k}"], f"{tag} grad {k}",
                       LOSS)
        for tree in ("params", "mu", "nu"):
            for k, x in out[f"{tag}/full"][tree].items():
                _close(x, ref[f"{tag}/{tree}/{k}"], f"{tag} {tree} {k}",
                       STATE)


@pytest.mark.parametrize("tag", list(CASES))
def test_each_rank_holds_the_references_shards(ref, ranks, tag):
    """Each rank's params, mu and nu are the reference device's
    ``addressable_shards`` under the same spec: cut over model, and
    ZeRO-1's (or FSDP's) second cut over data. A rank holds numel/model
    of each leaf cut over model (numel/4 where FSDP cuts it over data
    too)."""
    for r, out in enumerate(ranks):
        for tree in ("params", "mu", "nu"):
            for k, x in out[f"{tag}/local"][tree].items():
                want = ref[f"{tag}/shard/{tree}/{k}/{r}"]
                assert tuple(x.shape) == want.shape, (tag, tree, k, r)
                _close(x, want, f"{tag} {tree}/{k} on rank {r}", STATE)
        full = out[f"{tag}/full"]["params"]
        for k, (m, n) in out[f"{tag}/cuts"].items():
            assert out[f"{tag}/local"]["params"][k].numel() * m * n == \
                full[k].numel(), (tag, k)
    cut = {k for k, (m, _) in ranks[0][f"{tag}/cuts"].items() if m == 2}
    want = {"dense": {"embed", "unembed", "wq", "wk", "wv", "wo", "w_gate",
                      "w_up", "w_down"},
            "vocab": {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"},
            "granite": {"embed", "unembed", "wq", "wk", "wv", "wo", "w_up",
                        "w_down"}}
    want["kv1"] = want["seq"] = want["vlm"] = want["dense"]
    assert cut == want[tag]


def test_trainer_state_is_the_shadows_bitwise(ranks):
    """Rank 0's gathered trainer state equals the consolidated checkpoint
    of the shadow it hosts, bit for bit, through a `RankCapture` on
    (2, 2) and through train(rules=) with a failure at step 2 (which
    resumes at step 1); each step captured once."""
    for tag, steps in (("capture/tp", 2), ("loop/tp", 3)):
        trainer, shadow = ranks[0][f"{tag}/trainer"], ranks[0][f"{tag}/shadow"]
        assert shadow["step"] == trainer["step"] == steps
        assert ranks[0][f"{tag}/n_checkpoints"] == steps
        for tree in ("params", "mu", "nu"):
            assert set(shadow[tree]) == set(trainer[tree])
            for k, t in trainer[tree].items():
                assert torch.equal(shadow[tree][k], t), (tag, tree, k)
    assert all(out["loop/tp/recovered_at"] == [1] for out in ranks)
    assert all(out["loop/tp/losses"] == ranks[0]["loop/tp/losses"]
               for out in ranks)


def test_capture_covers_every_element_exactly_once(ranks):
    """Over all four ranks every element of every leaf is sent exactly
    once a step: a leaf's cuts over data and over model each by every
    rank along them, a dim held whole by the first rank along it."""
    shapes = {k: tuple(v.shape) for k, v in
              ranks[0]["dense/full"]["params"].items()}
    for t in range(2):
        counts = {k: np.zeros(s, np.int64) for k, s in shapes.items()}
        for out in ranks:
            for k, cuts in out[f"capture/tp/marks/{t}"]:
                idx = [slice(None)] * len(shapes[k])
                for d, lo, hi in cuts:
                    idx[d] = slice(lo, hi)
                counts[k][tuple(idx)] += 1
        for k, c in counts.items():
            assert (c == 1).all(), (t, k, np.unique(c))
        # every rank sends a share; a leaf cut over both dims is sent in
        # quarters, one by each rank
        assert all(out[f"capture/tp/marks/{t}"] for out in ranks)
        assert any(len(cuts) == 2 for _, cuts in
                   ranks[3][f"capture/tp/marks/{t}"])


@pytest.mark.parametrize("mesh", ["4x1", "1x4"])
def test_recovery_onto_another_mesh_resumes_bitwise(ranks, mesh):
    """The (2, 2) run's checkpoint at step 2 lands on (4, 1) and on
    (1, 4) (planned by `plan_elastic_mesh`) as each rank's slices of the
    trainer's state, bit for bit, and the next step from it is bitwise
    the step from the trainer's state handed straight over; on (1, 4) a
    rank holds a quarter of each model-cut leaf."""
    loss = ranks[0][f"resume/{mesh}/loss"]
    assert np.isfinite(loss)
    assert all(out[f"resume/{mesh}/loss"] == loss for out in ranks)
    full = ranks[0]["dense/full"]["params"]
    for out in ranks:
        for k, shape in out[f"resume/{mesh}/local"].items():
            m = 4 if mesh == "1x4" else 1
            cut = ranks[0]["dense/cuts"][k][0] == 2
            assert int(np.prod(shape)) * (m if cut else 1) == \
                full[k].numel(), (mesh, k)
