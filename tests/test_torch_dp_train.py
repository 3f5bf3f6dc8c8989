"""Data-parallel training over four gloo ranks on the CPU against the
reference's GSPMD step on four forced host devices.

The reference runs once, in a module-scoped subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
tests/test_elastic.py runs it), and dumps to an ``.npz``: its initial
params, each step's loss and (gathered) reduce-scattered gradients, the
final state and each device's ``addressable_shards`` of it, at f32
compute on ``.reduced()`` configs, and the shards of one array under the
specs of three meshes. The port then runs once on four gloo ranks
(``tests/_torch_dp_workers.py::dp_train``), from the reference's params
carried over by ``repro_torch.convert``, and each rank dumps what it saw.
Three ranks, where no leaf of the reduced model splits, run the replicated
path (each leaf all-reduced whole and captured from dp rank 0 alone)
against the port's own one-rank run.

Tolerances are tests/test_torch_model.py's and tests/test_torch_elastic.py's:
losses and gradients to rtol 1e-4 / atol 1e-6, states after the steps to
rtol 1e-5 / atol 1e-6. Inside the port the trainer and its shadow are
compared bit for bit (both run the same elementwise AdamW with the same
scalars).
"""
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_dp_workers import (BATCH, OPT, SEQ, SHARDING_CASES, dense_cfg,
                               initial_state, lr_fn, moe_cfg)
from _torch_spawn import spawn

from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.train.step import build_train_step

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
OPT = OptimizerConfig(lr=1e-3, eps=1e-5, grad_clip=0.5)


def mesh(shape, names):
    n = int(np.prod(shape))
    m = compat.make_mesh(shape, names, devices=jax.devices()[:n],
                         axis_types=(compat.AxisType.Auto,) * len(shape))
    assert [d.id for d in m.devices.flat] == list(range(n))
    return m


def shards(prefix, arr):
    for s in arr.addressable_shards:
        out[f"{prefix}/{s.device.id}"] = np.asarray(s.data)


def run(tag, cfg, rules, steps):
    m = rules.mesh
    state = make_train_state(jax.random.PRNGKey(0), cfg, rules)
    for k, v in state.params.items():
        out[f"{tag}/init/{k}"] = np.asarray(v)
    step = jax.jit(build_train_step(cfg, m, rules, OPT, lambda s: 1e-3))
    stream = SyntheticStream(cfg, 16, 16, seed=0)
    with m:
        for t in range(steps):
            state, met, g = step(state, device_batch(stream.batch_at(t),
                                                     rules))
            out[f"{tag}/loss/{t}"] = np.asarray(met["loss"])
            out[f"{tag}/gnorm/{t}"] = np.asarray(met["grad_norm"])
            for k, v in g.items():
                out[f"{tag}/grad/{t}/{k}"] = np.asarray(v)
    for tree in ("params", "mu", "nu"):
        for k, v in getattr(state, tree).items():
            out[f"{tag}/{tree}/{k}"] = np.asarray(v)
            shards(f"{tag}/shard/{tree}/{k}", v)


dense = C.get("tinyllama-1.1b").reduced(compute_dtype="float32",
                                        microbatches=2)
m41 = mesh((4, 1), ("data", "model"))
run("dense", dense, ShardingRules(m41), 3)
run("fsdp", dense, ShardingRules(m41, fsdp=True), 3)
moe = C.get("arctic-480b").reduced(compute_dtype="float32",
                                   capacity_factor=0.5, microbatches=2)
run("moe", moe, ShardingRules(m41), 2)
m11 = mesh((1, 1), ("data", "model"))        # the same first step, G = 1
r11 = ShardingRules(m11)
with m11:
    _, met, _ = jax.jit(build_train_step(moe, m11, r11, OPT,
                                         lambda s: 1e-3))(
        make_train_state(jax.random.PRNGKey(0), moe, r11),
        device_batch(SyntheticStream(moe, 16, 16, seed=0).batch_at(0), r11))
out["moe_g1/loss/0"] = np.asarray(met["loss"])

x = np.random.default_rng(0).standard_normal((8, 8, 4)).astype(np.float32)
out["x"] = x
CASES = %r
for name, shape, names in (("4x1", (4, 1), ("data", "model")),
                           ("2x2", (2, 2), ("data", "model")),
                           ("2x2x1", (2, 2, 1), ("pod", "data", "model"))):
    mm = mesh(shape, names)
    for fsdp in (0, 1):
        r = ShardingRules(mm, fsdp=bool(fsdp))
        for i, logical in enumerate(CASES):
            sh = r.sharding(*logical, dims=x.shape)
            shards(f"local/{name}/{fsdp}/{i}", jax.device_put(x, sh))
            out[f"spec/{name}/{fsdp}/{i}"] = np.array(repr(tuple(sh.spec)))
np.savez(sys.argv[1], **out)
""" % (SHARDING_CASES,)


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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
def three(tmp_path_factory):
    """What each of three ranks saw (``three_ranks``'s dumps): every leaf
    replicated."""
    d = tmp_path_factory.mktemp("three")
    spawn("_torch_dp_workers", "three_ranks", 3, d, str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(3)]


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    """What each of the four ranks saw (``dp_train``'s dumps)."""
    d = tmp_path_factory.mktemp("ranks")
    # seven runs in one spawn: a longer join deadline than one collective's
    spawn("_torch_dp_workers", "dp_train", WORLD, d, ref_path, str(d),
          timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _close(got, want, what, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **tol)


def _tree_close(tree, ref, prefix, tol):
    assert set(tree) == {k.split("/")[-1] for k in ref
                         if k.startswith(prefix + "/")
                         and k.count("/") == prefix.count("/") + 1}
    for k, t in tree.items():
        _close(t, ref[f"{prefix}/{k}"], f"{prefix}/{k}", tol)


@pytest.mark.parametrize("tag,steps", [("dense", 3), ("fsdp", 3)])
def test_four_ranks_match_the_reference_step(ref, ranks, tag, steps):
    """tinyllama (reduced, f32, 2 microbatches, the clip binding) on a
    (4, 1) mesh, 3 steps, with FSDP off and on: each rank's loss, the
    gathered reduced gradients and the state against the reference's."""
    for r, out in enumerate(ranks):
        for t in range(steps):
            assert out[f"{tag}/loss/{t}"] == pytest.approx(
                float(ref[f"{tag}/loss/{t}"]), rel=LOSS["rtol"])
            _tree_close(out[f"{tag}/grad/{t}"], ref, f"{tag}/grad/{t}", LOSS)
        for tree in ("params", "mu", "nu"):
            _tree_close(out[f"{tag}/full"][tree], ref, f"{tag}/{tree}",
                        STATE)


def test_four_ranks_match_one_rank(ref, ranks):
    """The port's 4-rank run against its own 1-rank run from the same
    params: the sums run in other orders, so to the tolerances."""
    cfg = dense_cfg()
    state = initial_state(ref, "dense", cfg)
    step = build_train_step(cfg, OPT, lr_fn)
    assert step.sharding is None
    stream = SyntheticStream(cfg, BATCH, SEQ, seed=0)
    four = ranks[0]
    for t in range(3):
        state, met, grads = step(state, device_batch(stream.batch_at(t),
                                                     "cpu"))
        assert float(met["loss"]) == pytest.approx(
            four[f"dense/loss/{t}"], rel=LOSS["rtol"])
        for k, g in grads.items():
            _close(four[f"dense/grad/{t}"][k], g.numpy(), k, LOSS)
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(state, tree).items():
            _close(four["dense/full"][tree][k], t.numpy(), k, STATE)


@pytest.mark.parametrize("tag", ["capture/4x1", "capture/2x2",
                                 "capture/moe2x2", "loop/4x1", "loop/fsdp",
                                 "capture/3x1", "loop/3x1"])
def test_trainer_state_is_the_shadows_bitwise(request, tag):
    """Rank 0's gathered trainer state equals the consolidated checkpoint
    of the shadow it hosts, bit for bit: the capture through a
    `RankCapture` on (4, 1), (2, 2) (dense, and arctic with its experts
    cut over model)
    and (3, 1) (every leaf replicated), and train(rules=) with a failure at step 2 (FSDP off and on, and on
    three ranks), which resumes at step 1."""
    ranks = request.getfixturevalue("three" if "3x1" in tag else "ranks")
    trainer, shadow = ranks[0][f"{tag}/trainer"], ranks[0][f"{tag}/shadow"]
    assert shadow["step"] == trainer["step"]
    for tree in ("params", "mu", "nu"):
        assert set(shadow[tree]) == set(trainer[tree])
        for k, t in trainer[tree].items():
            assert torch.equal(shadow[tree][k], t), (tag, tree, k)
    if tag.startswith("loop"):
        assert all(out[f"{tag}/recovered_at"] == [1] for out in ranks)
        assert all(out[f"{tag}/losses"] == ranks[0][f"{tag}/losses"]
                   for out in ranks)


def _moe_marks(r: int) -> list:
    """What rank ``r`` of the (2, 2) mesh (FSDP off, as the captured run)
    sends of arctic's reduced gradients, from the specs: each leaf cut
    over data or model, its ZeRO-1 slice and its model slice, where the
    rank is the first along every dim the leaf holds whole."""
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import registry
    from repro_torch.optim.sharded import zero1_spec

    class Mesh22:
        shape = {"data": 2, "model": 2}
        axis_names = ("data", "model")
    cfg = moe_cfg()
    rules = ShardingRules(Mesh22())
    a, b = divmod(r, 2)
    marks = []
    for k, ps in registry.param_specs(cfg).items():
        spec = zero1_spec(ps.shape, rules.spec(*ps.logical, dims=ps.shape),
                          Mesh22())
        cuts = [(spec.index(ax), i) for ax, i in (("data", a), ("model", b))
                if ax in spec]
        if not cuts or any(i for ax, i in (("data", a), ("model", b))
                           if ax not in spec):
            continue
        marks.append((k, tuple((d, i * ps.shape[d] // 2,
                                (i + 1) * ps.shape[d] // 2)
                               for d, i in cuts)))
    return marks


@pytest.mark.parametrize("mesh", ["4x1", "2x2", "moe2x2", "3x1"])
def test_capture_covers_every_element_exactly_once(request, mesh):
    """Each rank's marks of what it packed at each step: over all ranks
    every element of every leaf is covered exactly once. On (2, 2) the
    tensor-parallel dense model's leaves are cut over model too, so every
    rank sends a share, the model-index-1 ranks (1 and 3) only slices cut
    over model; arctic on (2, 2) has its experts (and its attention,
    dense residual and vocab) cut over model, so ranks 1, 2 and 3 each
    send exactly the slices the specs give them (their model half of each
    leaf cut over model, and their data half where the leaf is cut over
    data too), and rank 0 receives exactly those, with no padding; on
    (3, 1), where every leaf is replicated, dp rank 0 sends each leaf
    whole and the others nothing."""
    ranks = request.getfixturevalue("three" if mesh == "3x1" else "ranks")
    shapes = {k: tuple(v.shape) for k, v in ranks[0][
        "moe/full" if mesh == "moe2x2" else "dense/full"]["params"].items()}

    def numel(k, cuts):
        return math.prod(shapes[k]) // math.prod(
            shapes[k][d] // (hi - lo) for d, lo, hi in cuts)
    for t in range(2):
        counts = {k: np.zeros(s, np.int64) for k, s in shapes.items()}
        for out in ranks:
            for k, cuts in out[f"capture/{mesh}/marks/{t}"]:
                idx = [slice(None)] * len(shapes[k])
                for d, lo, hi in cuts:
                    idx[d] = slice(lo, hi)
                counts[k][tuple(idx)] += 1
        for k, c in counts.items():
            assert (c == 1).all(), (mesh, t, k, np.unique(c))
        if mesh == "2x2":
            for r in (1, 3):
                marks = ranks[r][f"capture/{mesh}/marks/{t}"]
                assert marks and all(
                    any(lo > 0 for _, lo, _ in cuts) for _, cuts in marks)
        if mesh == "moe2x2":
            for r in (1, 2, 3):
                sent = ranks[r][f"capture/{mesh}/marks/{t}"]
                assert sent == _moe_marks(r), r
            assert {k for k, _ in _moe_marks(1)} >= {"we_gate", "we_up",
                                                     "we_down"}
            assert ranks[0][f"capture/{mesh}/received/{t}"] == sum(
                numel(k, cuts) for r in (1, 2, 3)
                for k, cuts in ranks[r][f"capture/{mesh}/marks/{t}"])
        if mesh == "3x1":
            assert ranks[0][f"capture/{mesh}/received/{t}"] == 0
            assert all(cuts == () for _, cuts in
                       ranks[0][f"capture/{mesh}/marks/{t}"])
            assert ranks[1][f"capture/{mesh}/marks/{t}"] == []
            assert ranks[2][f"capture/{mesh}/marks/{t}"] == []


def test_three_ranks_with_every_leaf_replicated_match_one_rank(three):
    """On three ranks no leaf splits, so each is all-reduced whole and
    updated whole on every rank: losses, reduced gradients and state
    against the port's 1-rank run from the same params, to the
    tolerances, and the same state on every rank, bit for bit."""
    from repro_torch.optim.functional import init_state
    cfg = dense_cfg()
    state = init_state({k: t.clone() for k, t in three[0]["init"].items()})
    step = build_train_step(cfg, OPT, lr_fn)
    stream = SyntheticStream(cfg, 12, SEQ, seed=0)
    for t in range(3):
        state, met, grads = step(state, device_batch(stream.batch_at(t),
                                                     "cpu"))
        assert float(met["loss"]) == pytest.approx(
            three[0][f"dense/loss/{t}"], rel=LOSS["rtol"])
        for k, g in grads.items():
            _close(three[0][f"dense/grad/{t}"][k], g.numpy(), k, LOSS)
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(state, tree).items():
            local = three[0]["dense/local"][tree][k]
            assert local.shape == t.shape       # replicated: whole
            _close(local, t.numpy(), k, STATE)
            for other in three[1:]:
                assert torch.equal(other["dense/local"][tree][k], local)


@pytest.mark.parametrize("tag,trees", [("dense", ("mu", "nu")),
                                       ("fsdp", ("params", "mu", "nu"))])
def test_state_slices_are_the_references_shards(ref, ranks, tag, trees):
    """Each rank's mu and nu are its ZeRO-1 slices: equal to the
    reference's ``addressable_shards`` on the same device index under
    ``zero1_shardings``; under FSDP its params are its shards under the
    param spec too."""
    for r, out in enumerate(ranks):
        for tree in trees:
            for k, t in out[f"{tag}/local"][tree].items():
                want = ref[f"{tag}/shard/{tree}/{k}/{r}"]
                assert tuple(t.shape) == want.shape, (tag, tree, k, r)
                _close(t, want, f"{tree}/{k} on rank {r}", STATE)
        if tag == "dense":    # ZeRO-1 cuts the moments, not the params
            for k, t in out["dense/local"]["params"].items():
                assert tuple(t.shape) == ref[f"dense/params/{k}"].shape


def test_moe_groups_match_the_reference_at_g4(ref, ranks):
    """Reduced arctic-480b (capacity factor 0.5, f32, 2 microbatches) on
    4 dp ranks, G = 4 token groups with their own capacity and the
    load-balance loss over all groups, against the reference at G = 4;
    first, that the grouping shows: the reference's G = 4 loss is not its
    G = 1 loss. Each group is the rank's rows of one microbatch, so the
    rows must follow the reference's microbatch layout too."""
    assert abs(float(ref["moe/loss/0"]) - float(ref["moe_g1/loss/0"])) > 1e-3
    for out in ranks:
        for t in range(2):
            assert out[f"moe/loss/{t}"] == pytest.approx(
                float(ref[f"moe/loss/{t}"]), rel=LOSS["rtol"])
            _tree_close(out[f"moe/grad/{t}"], ref, f"moe/grad/{t}", LOSS)
        for tree in ("params", "mu", "nu"):
            _tree_close(out["moe/full"][tree], ref, f"moe/{tree}", STATE)


@pytest.mark.parametrize("mesh", ["4x1", "2x2", "2x2x1"])
def test_local_is_the_addressable_shard(ref, ranks, mesh):
    """``sharding(...).local(x)`` on rank r against the reference's
    ``addressable_shards`` on device r, FSDP off and on: the same spec,
    and the same slice, (pod, data) split row-major pod first, a dim on
    ``model`` cut as the reference cuts it. (Where a dim on ``model`` is
    held whole, the reference's shard is the model block of the port's
    slice.)"""
    names = {"4x1": ("data", "model"), "2x2": ("data", "model"),
             "2x2x1": ("pod", "data", "model")}[mesh]
    for fsdp in (0, 1):
        for i, logical in enumerate(SHARDING_CASES):
            spec = str(ref[f"spec/{mesh}/{fsdp}/{i}"])
            for r, out in enumerate(ranks):
                assert out[f"spec/{mesh}/{fsdp}/{i}"] == spec
                got = out[f"local/{mesh}/{fsdp}/{i}"]
                want = ref[f"local/{mesh}/{fsdp}/{i}/{r}"]
                m = out[f"coords/{mesh}"]["model"]
                for d, name in enumerate(logical):
                    if name in ("heads", "ff") and \
                            got.shape[d] != want.shape[d]:
                        s = want.shape[d]
                        got = got.narrow(d, m * s, s)
                assert np.array_equal(got.numpy(), want), \
                    (mesh, fsdp, logical, r, names)


class _Rank:
    """Rules over a stand-in ("data", "model") mesh, at data index r."""

    def __init__(self, n, r):
        self.mesh = type("M", (), {
            "axis_names": ("data", "model"), "shape": {"data": n, "model": 1},
            "coordinate": lambda self, axes: r})()

    def axis_size(self, logical):
        return self.mesh.shape["data"]


def test_local_rows_follow_the_reference_microbatches():
    """Microbatch i of a global batch of 16 in 2 microbatches is rows
    8i..8i+7, and dp rank r of 4 works on the r-th quarter of each: rows
    2r, 2r+1, 8+2r, 9+2r (not the r-th quarter of the whole batch). A
    microbatch that does not split over the ranks raises."""
    from repro_torch.data.synthetic import local_rows
    for r in range(4):
        assert list(local_rows(16, _Rank(4, r), 2)) == \
            [2 * r, 2 * r + 1, 8 + 2 * r, 9 + 2 * r]
    assert list(local_rows(16, _Rank(4, 1), 1)) == [4, 5, 6, 7]
    assert list(local_rows(6, None, 2)) == list(range(6))
    batch = {"tokens": np.arange(32).reshape(16, 2)}
    got = device_batch(batch, "cpu", _Rank(4, 3), microbatches=2)["tokens"]
    assert got[:, 0].tolist() == [12, 14, 28, 30]
    with pytest.raises(ValueError, match="does not split over 4"):
        local_rows(12, _Rank(4, 0), 2)
