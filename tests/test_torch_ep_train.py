"""Expert-parallel training of the MoE family over a (2, 2) ("data",
"model") mesh of four gloo ranks on the CPU against the reference's GSPMD
step on four forced host devices.

The reference runs once, in a module-scoped subprocess
(`_torch_gspmd.run_reference`), on four ``.reduced()`` cases at f32
compute, 2 microbatches, 3 steps: arctic-480b (4 experts top-2, two a
model rank, the dense residual, FSDP over data), arctic at capacity factor
0.5 (slots drop in every group), dbrx-132b (no residual) and arctic with
3 experts (which do not split over 2 model ranks: whole experts, the rest
of the block tensor-parallel). The port runs once on four gloo ranks
(``tests/_torch_ep_workers.py::ep_train``) from the reference's params
carried over by ``repro_torch.convert``; each rank dumps what it saw.

Tolerances are tests/test_torch_tp_train.py's: losses and gradients to
rtol 1e-4 / atol 1e-6, states to rtol 1e-5 / atol 1e-6, with AdamW at
eps 1e-4 in both packages. Inside the port the trainer and its shadow
are compared bit for bit, each step is captured once, and the (2, 2)
run's checkpoint is restored onto (4, 1) and (1, 4).
"""
import numpy as np
import pytest
import torch

from _torch_ep_workers import CASES
from _torch_gspmd import run_reference
from _torch_spawn import spawn
from _torch_tp_workers import EPS, STEPS

torch.set_num_threads(2)   # leave cores to the other test workers

WORLD = 4
LOSS = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-5, atol=1e-6)
EXPERTS = ("we_gate", "we_up", "we_down")


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    return run_reference(str(tmp_path_factory.mktemp("ref") / "ref.npz"),
                         CASES, EPS, STEPS)


@pytest.fixture(scope="module")
def ref(ref_path):
    return dict(np.load(ref_path))


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    """What each of the four ranks saw (``ep_train``'s dumps)."""
    d = tmp_path_factory.mktemp("ranks")
    spawn("_torch_ep_workers", "ep_train", WORLD, d, ref_path, str(d),
          timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _close(got, want, what, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **tol)


@pytest.mark.parametrize("tag", list(CASES))
def test_two_by_two_matches_the_reference_step(ref, ranks, tag):
    """Each rank's loss (the aux loss in it), grad norm (the clip binds),
    the gathered reduced gradients and the final state against the
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
    ``addressable_shards``: the experts cut over model (2 of 4 a rank)
    and their ``wemb`` dim over data under FSDP, so a rank holds a
    quarter of each expert leaf; with 3 experts the expert leaves are
    whole over model (cut over data alone) and the rest of the block is
    cut as the dense family's."""
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
    cuts = ranks[0][f"{tag}/cuts"]
    cut = {k for k, (m, _) in cuts.items() if m == 2}
    block = {"embed", "unembed", "wq", "wk", "wv", "wo"}
    residual = {"w_gate", "w_up", "w_down"}
    want = {"arctic": block | residual | set(EXPERTS),
            "dbrx": block | set(EXPERTS), "e3": block | residual}
    want["drop"] = want["arctic"]
    assert cut == want[tag]
    assert all(cuts[k] == ((1, 2) if tag == "e3" else (2, 2))
               for k in EXPERTS)


def test_slots_drop_at_capacity_factor_half(ref):
    """The drop case differs from arctic only by its capacity: its losses
    differ, so slots did drop (and the port matched the reference through
    them above)."""
    assert all(float(ref[f"drop/loss/{t}"]) != float(ref[f"arctic/loss/{t}"])
               for t in range(STEPS))


def test_trainer_state_is_the_shadows_bitwise(ranks):
    """Rank 0's gathered trainer state equals the consolidated checkpoint
    of the shadow it hosts, bit for bit, through a `RankCapture` on
    (2, 2) and through train(rules=) with a failure at step 2 (which
    resumes at step 1); each step captured once."""
    for tag, steps in (("capture/ep", 2), ("loop/ep", 3)):
        trainer, shadow = ranks[0][f"{tag}/trainer"], ranks[0][f"{tag}/shadow"]
        assert shadow["step"] == trainer["step"] == steps
        assert ranks[0][f"{tag}/n_checkpoints"] == steps
        for tree in ("params", "mu", "nu"):
            assert set(shadow[tree]) == set(trainer[tree])
            for k, t in trainer[tree].items():
                assert torch.equal(shadow[tree][k], t), (tag, tree, k)
    assert all(out["loop/ep/recovered_at"] == [1] for out in ranks)
    assert all(out["loop/ep/losses"] == ranks[0]["loop/ep/losses"]
               for out in ranks)


def test_capture_covers_every_element_exactly_once(ranks):
    """Over all four ranks every element of every leaf is sent exactly
    once a step; each expert leaf in quarters, one by each rank (its
    expert cut over model, its wemb cut over data)."""
    shapes = {k: tuple(v.shape) for k, v in
              ranks[0]["arctic/full"]["params"].items()}
    for t in range(2):
        counts = {k: np.zeros(s, np.int64) for k, s in shapes.items()}
        for out in ranks:
            for k, cuts in out[f"capture/ep/marks/{t}"]:
                idx = [slice(None)] * len(shapes[k])
                for d, lo, hi in cuts:
                    idx[d] = slice(lo, hi)
                counts[k][tuple(idx)] += 1
        for k, c in counts.items():
            assert (c == 1).all(), (t, k, np.unique(c))
        for r, out in enumerate(ranks):
            sent = dict(out[f"capture/ep/marks/{t}"])
            for k in EXPERTS:
                e, wemb = (1, 2) if k != "we_down" else (1, 3)
                half = shapes[k][e] // 2, shapes[k][wemb] // 2
                a, b = divmod(r, 2)
                assert sorted(sent[k]) == sorted([
                    (e, b * half[0], (b + 1) * half[0]),
                    (wemb, a * half[1], (a + 1) * half[1])]), (r, k)


@pytest.mark.parametrize("mesh", ["4x1", "1x4"])
def test_recovery_onto_another_mesh_resumes_bitwise(ranks, mesh):
    """The (2, 2) run's checkpoint at step 2 lands on (4, 1) and on
    (1, 4) (planned by `plan_elastic_mesh`, FSDP kept) as each rank's
    slices of the trainer's state, bit for bit, and the next step from it
    is bitwise the step from the trainer's state handed straight over; on
    (1, 4) a rank holds one of the 4 experts, on (4, 1) a quarter of each
    expert's wemb dim."""
    loss = ranks[0][f"resume/{mesh}/loss"]
    assert np.isfinite(loss)
    assert all(out[f"resume/{mesh}/loss"] == loss for out in ranks)
    full = ranks[0]["arctic/full"]["params"]
    for out in ranks:
        local = out[f"resume/{mesh}/local"]
        for k in EXPERTS:
            want = list(full[k].shape)
            want[1 if mesh == "1x4" else (3 if k == "we_down" else 2)] //= 4
            assert list(local[k]) == want, (mesh, k)
