"""Tensor-parallel training of the ssm, hybrid, audio and vit families over
a (2, 2) ("data", "model") mesh of four gloo ranks on the CPU, against the
reference's GSPMD step on four forced host devices; the ``sum_over_model``
Function's gradient; and training on a (1, 1) mesh bitwise training with
no rules.

The reference runs once, in a module-scoped subprocess
(``tests/_torch_gspmd.py::run_reference``: f32 compute, 2 microbatches, 3
steps, AdamW at eps 1e-4 with a clip of 0.5) on five ``.reduced()`` cases
(``tests/_torch_tp_families_workers.py::CASES``): mamba2, mamba2 with a
vocab of 255 under FSDP, zamba2, whisper and vit-h-14 as a ViT. The port
runs once on four gloo ranks from the reference's params carried over by
``repro_torch.convert`` (``families_train``); each rank dumps what it saw.

Tolerances are tests/test_torch_tp_train.py's: losses and gradients to
rtol 1e-4 / atol 1e-6, states and each rank's shards to rtol 1e-5 / atol
1e-6. Inside the port the trainer and its shadow are compared bit for
bit, each step captured once and every element sent exactly once.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_gspmd import run_reference
from _torch_spawn import spawn
from _torch_tp_families_workers import CAPTURE_STEPS, CASES, MODEL_CUT
from _torch_tp_workers import EPS, STEPS

from repro_torch import configs as TC
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
from repro_torch.models import registry
from repro_torch.optim.functional import OptimizerConfig, init_state
from repro_torch.train.step import build_train_step

torch.set_num_threads(2)   # leave cores to the other test workers

WORLD = 4
LOSS = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    return run_reference(str(tmp_path_factory.mktemp("ref") / "ref.npz"),
                         CASES, EPS, STEPS)


@pytest.fixture(scope="module")
def ref(ref_path):
    return dict(np.load(ref_path))


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    """What each of the four ranks saw (``families_train``'s dumps)."""
    d = tmp_path_factory.mktemp("ranks")
    spawn("_torch_tp_families_workers", "families_train", WORLD, d,
          ref_path, str(d), timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _close(got, want, what, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **tol)


@pytest.mark.parametrize("tag", list(CASES))
def test_two_by_two_matches_the_reference_step(ref, ranks, tag):
    """Each rank's loss and grad norm, the gathered reduced gradients and
    the final state against the reference's GSPMD step on the same
    mesh."""
    for out in ranks:
        for t in range(STEPS):
            assert out[f"{tag}/loss/{t}"] == pytest.approx(
                float(ref[f"{tag}/loss/{t}"]), rel=LOSS["rtol"])
            gnorm = float(ref[f"{tag}/gnorm/{t}"])
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
    ``addressable_shards``: the ``ssm_inner``, heads, ff and vocab dims cut
    over model where they divide it, ZeRO-1's (or FSDP's) second cut over
    data; the leaves cut over model are the ones the specs cut."""
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
    assert cut == MODEL_CUT[tag]
    if tag == "mamba2_fsdp":        # wemb over data, ssm_inner over model
        assert any(n == 2 and m == 2 for m, n in
                   ranks[0][f"{tag}/cuts"].values())


@pytest.mark.parametrize("tag", list(CASES))
def test_trainer_state_is_the_shadows_bitwise(ranks, tag):
    """Rank 0's gathered trainer state equals the consolidated checkpoint
    of the shadow it hosts, bit for bit, through a `RankCapture` on
    (2, 2); each step captured once, and over the four ranks every
    element of every leaf sent exactly once a step."""
    pre = f"capture/{tag}"
    trainer, shadow = ranks[0][f"{pre}/trainer"], ranks[0][f"{pre}/shadow"]
    assert shadow["step"] == trainer["step"] == CAPTURE_STEPS
    assert ranks[0][f"{pre}/n_checkpoints"] == CAPTURE_STEPS
    for tree in ("params", "mu", "nu"):
        assert set(shadow[tree]) == set(trainer[tree])
        for k, t in trainer[tree].items():
            assert torch.equal(shadow[tree][k], t), (tag, tree, k)
    shapes = {k: tuple(v.shape) for k, v in trainer["params"].items()}
    for t in range(CAPTURE_STEPS):
        counts = {k: np.zeros(s, np.int64) for k, s in shapes.items()}
        for out in ranks:
            for k, cuts in out[f"{pre}/marks/{t}"]:
                idx = [slice(None)] * len(shapes[k])
                for d, lo, hi in cuts:
                    idx[d] = slice(lo, hi)
                counts[k][tuple(idx)] += 1
        for k, c in counts.items():
            assert (c == 1).all(), (tag, t, k, np.unique(c))


def test_a_gathered_leafs_gradient_is_contiguous(ranks):
    """A leaf cut inside its kv heads is gathered whole along its last dim
    (`tensor_parallel.gather_from_model`, as the attention does for a
    shared block's ``wk`` at more model ranks than kv heads); the
    gradient it gets back is this rank's slice of the summed gradient,
    contiguous (AdamW reads it flat), on every rank."""
    for out in ranks:
        got, want = out["gather/grad"], out["gather/want"]
        assert got.is_contiguous()
        assert torch.equal(got, want)


# -- one process ---------------------------------------------------------------

def _two_ranks(fn):
    """``fn(tp)`` on two ranks of one process: a gloo group each, made on
    one store, in a thread each; returns their results by rank."""
    store, out, errs = dist.HashStore(), {}, []

    def run(r):
        try:
            group = dist.ProcessGroupGloo(store, r, 2)
            out[r] = fn(SimpleNamespace(group=group, size=2, rank=r))
        except Exception as e:        # surfaced below, with its rank
            errs.append((r, e))
    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    return out


def test_sum_over_model_gradient_matches_the_closed_form():
    """``y_r = a_r * rsqrt(S / n + eps)`` on each of two ranks with
    ``S = sum_over_model(sum(a_r ** 2))``, the gated norm's form, and the
    loss ``sum_r <g_r, y_r>``: each rank's autograd gradient of its part
    is the closed form ``g_r * inv - a_r * inv**3 / n * sum_r' <g_r',
    a_r'>`` (the other rank's term arrives through the backward's
    all-reduce); `reduce_from_model` in its place misses it."""
    gen = torch.Generator().manual_seed(7)
    a = torch.randn(2, 3, 5, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 3, 5, generator=gen, dtype=torch.float64)
    n, eps = 10, 1e-5
    inv = torch.rsqrt((a * a).sum(dim=(0, 2)) / n + eps)[:, None]
    dot = (g * a).sum(dim=(0, 2))[:, None]
    want = [g[r] * inv - a[r] * inv ** 3 / n * dot for r in range(2)]

    def grad_of(op):
        def fn(tp):
            x = a[tp.rank].clone().requires_grad_(True)
            s = op(torch.sum(x * x, dim=-1, keepdim=True), tp)
            y = x * torch.rsqrt(s / n + eps)
            (gx,) = torch.autograd.grad(y, x, g[tp.rank])
            return y.detach(), gx
        return _two_ranks(fn)
    got = grad_of(TP.sum_over_model)
    for r in range(2):
        torch.testing.assert_close(got[r][0], a[r] * inv, rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(got[r][1], want[r], rtol=1e-12,
                                   atol=1e-12)
    bad = grad_of(TP.reduce_from_model)
    assert not torch.allclose(bad[0][1], want[0])


ONE_BY_ONE = {"ssm": ("mamba2-2.7b", {}), "hybrid": ("zamba2-1.2b", {}),
              "audio": ("whisper-medium", {}),
              "vit": ("vit-h-14", {"family": "vit"})}


@pytest.mark.parametrize("family", list(ONE_BY_ONE))
def test_one_by_one_mesh_trains_bitwise_as_no_rules(family):
    """On the (1, 1) mesh the family's loss takes no context and calls no
    collective: its loss and gradients under the mesh's rules equal those
    with no rules bit for bit, and two steps of the built step leave the
    same state, at bf16 compute."""
    arch, over = ONE_BY_ONE[family]
    cfg = TC.get(arch).reduced(microbatches=2, **over)
    assert cfg.family == family and registry.tensor_parallel(cfg)
    rules = ShardingRules(make_smoke_mesh("cpu"), fsdp=cfg.fsdp)
    assert registry.family_module(cfg).tp_context(cfg, rules) is None
    params = registry.init_params(cfg, 0, "cpu")
    stream = SyntheticStream(cfg, 4, 16, seed=0)
    batch = device_batch(stream.batch_at(0), "cpu")
    runs = []
    for r in (rules, None):
        leaves = {k: p.clone().requires_grad_(True)
                  for k, p in params.items()}
        loss = registry.loss_fn(leaves, cfg, batch, rules=r)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        state = init_state({k: p.clone() for k, p in params.items()})
        step = build_train_step(cfg, OptimizerConfig(), lambda s: 1e-3, r)
        for t in range(2):
            state, _, _ = step(state, device_batch(stream.batch_at(t),
                                                   "cpu"))
        runs.append((loss, grads, state))
    (la, ga, sa), (lb, gb, sb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(sa, tree).items():
            assert torch.equal(t, getattr(sb, tree)[k]), (family, tree, k)
