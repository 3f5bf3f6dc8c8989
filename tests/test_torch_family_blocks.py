"""The family-specific blocks of the port against the JAX package's, on
the CPU: the MoE dispatch (capacity drops, tied router logits), the SSM's
causal conv and SSD scan (including where the reference overflows), and
each family's shadow checkpoint bitwise the trainer's.

Tolerances: the MoE outputs and the SSD scan to rtol 1e-5 / atol 1e-6 at
f32; the MoE gradients to rtol 1e-5 / atol 1e-6 times the leaf's largest
magnitude (an element there is a sum of terms up to that size, whose f32
rounding is relative to it). Inside the port: bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as C
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.models import moe as JMoE
from repro.models import ssm as JSSM

from repro_torch import configs as TC
from repro_torch.core.channel import InProcessChannel
from repro_torch.core.recovery import FailurePlan
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.models import moe as TMoE
from repro_torch.models import registry as treg
from repro_torch.models import ssm as TSSM
from repro_torch.train.loop import train

torch.set_num_threads(2)   # leave cores to the other test workers

RNG = np.random.default_rng(11)

FAMILIES = {"dense-gelu2": "granite-34b", "moe": "dbrx-132b",
            "moe-residual": "arctic-480b", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-1.2b", "audio": "whisper-medium",
            "vlm": "llava-next-mistral-7b", "vit": "vit-h-14"}


@pytest.fixture(scope="module")
def rules():
    return ShardingRules(make_smoke_mesh())


def _configs(family, **over):
    arch = FAMILIES[family]
    j, t = C.get(arch).reduced(**over), TC.get(arch).reduced(**over)
    if family == "vit":
        j, t = (dataclasses.replace(c, family="vit") for c in (j, t))
    return j, t


def _moe_pair(rules, cfg_over, router=None, T=32):
    """moe_ffn of both packages on the same f32 inputs: y, aux and the
    gradients of sum(y * r) + aux equal. Returns the port's config and
    inputs, and y."""
    jcfg, tcfg = _configs("moe", compute_dtype="float32", **cfg_over)
    d, e, f = jcfg.d_model, jcfg.num_experts, jcfg.moe_d_ff
    lp = {"router": RNG.standard_normal((d, e)) * 0.3 if router is None
          else router,
          "we_gate": RNG.standard_normal((e, d, f)) * d ** -0.5,
          "we_up": RNG.standard_normal((e, d, f)) * d ** -0.5,
          "we_down": RNG.standard_normal((e, f, d)) * f ** -0.5}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    x = RNG.standard_normal((2, T // 2, d)).astype(np.float32)
    r = RNG.standard_normal(x.shape).astype(np.float32)

    def jfn(x, lp):
        y, aux = JMoE.moe_ffn(x, lp, jcfg, rules)
        return jnp.sum(y * r) + aux, (y, aux)
    (_, (jy, jaux)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                           {k: jnp.asarray(v)
                                            for k, v in lp.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tlp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lp.items()}
    ty, taux = TMoE.moe_ffn(tx, tlp, tcfg)
    tgrads = torch.autograd.grad(
        (ty * torch.from_numpy(r)).sum() + taux, [tx, *tlp.values()])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    assert float(taux.detach()) == pytest.approx(float(jaux), rel=1e-5)
    jflat = [jgrads[0]] + [jgrads[1][k] for k in tlp]
    for name, a, b in zip(["x", *tlp], tgrads, jflat):
        b = np.asarray(b)
        # an element is a sum of terms up to the leaf's largest in size
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(b).max()),
                                   err_msg=name)
    return tcfg, x, lp, ty.detach()


def test_moe_ffn_drops_past_capacity_like_jax(rules):
    """Capacity 4 a expert for 32 tokens x top-2 over 4 experts: most
    slots drop; outputs and gradients equal JAX's, and a token whose every
    slot dropped gets y = 0 and no gradient through y."""
    tcfg, x, lp, y = _moe_pair(rules, dict(capacity_factor=0.25))
    T = x.shape[0] * x.shape[1]
    assert TMoE.capacity(tcfg, T) == 4
    gone = y.reshape(T, -1).abs().sum(-1) == 0
    assert 0 < int(gone.sum()) < T
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = TMoE.moe_ffn(tx, {k: torch.from_numpy(v) for k, v in lp.items()},
                        tcfg)
    gx, = torch.autograd.grad((y * torch.randn_like(y)).sum(), [tx])
    assert torch.all(gx.reshape(T, -1)[gone] == 0)
    assert torch.all(gx.reshape(T, -1)[~gone].abs().sum(-1) > 0)


def test_moe_top_k_breaks_ties_toward_the_lower_expert_like_jax(rules):
    """Router columns 0, 1 and 2 equal and column 3 zero: every token's
    logits for experts 0-2 tie, so top-2 takes 0 and 1 (or 3 and 0 where
    the tied logit is negative) and never 2, the order of
    ``jax.lax.top_k``; outputs and gradients equal JAX's."""
    jcfg, _ = _configs("moe")
    d = jcfg.d_model
    col = RNG.standard_normal((d, 1)) * 0.3
    router = np.concatenate([col, col, col, 0 * col], axis=1)
    router = router.astype(np.float32)
    tcfg, x, _, _ = _moe_pair(rules, {}, router=router)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, d)
                          @ torch.from_numpy(router), -1)
    _, idx = TMoE.top_k(probs, 2)
    assert not (idx == 2).any()
    assert set(map(tuple, idx.tolist())) == {(0, 1), (3, 0)}
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.array_equal(np.asarray(jidx), idx.numpy())


def test_causal_conv_matches_jax():
    x = RNG.standard_normal((2, 12, 6)).astype(np.float32)
    k = RNG.standard_normal((4, 6)).astype(np.float32)
    np.testing.assert_allclose(
        TSSM.causal_conv(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
        np.asarray(JSSM.causal_conv(jnp.asarray(x), jnp.asarray(k))),
        rtol=1e-6, atol=1e-6)


def _ssd_inputs(b, s, h, p, n, dt_scale):
    x = RNG.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (RNG.uniform(0.5, 1.5, (b, s, h)) * dt_scale).astype(np.float32)
    A = -RNG.uniform(0.5, 1.5, (h,)).astype(np.float32)
    B = RNG.standard_normal((b, s, n)).astype(np.float32)
    Cm = RNG.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, Cm


def _ssd(mod, xp, args, chunk):
    y, S = mod.ssd_chunked(*(xp(a) for a in args), chunk)
    return np.asarray(y), np.asarray(S)


@pytest.mark.parametrize("chunk", [4, 8, 16, 48])
def test_ssd_chunked_matches_jax_where_it_is_finite(chunk):
    args = _ssd_inputs(2, 48, 3, 4, 5, 0.1)
    jy, jS = _ssd(JSSM, jnp.asarray, args, chunk)
    ty, tS = _ssd(TSSM, torch.from_numpy, args, chunk)
    assert np.all(np.isfinite(jy))
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tS, jS, rtol=1e-5, atol=1e-6)


def test_ssd_chunked_stays_finite_where_the_reference_overflows():
    """dt * |A| about 0.5 a position: the exponents of a 256-long chunk
    span about 128, past exp's f32 range. The reference's unmasked
    exponent overflows and its y is NaN in the early rows; the port's is
    finite and, SSD not depending on the chunk length, equals the
    reference at chunk 16. dt and A are dyadic here, so every cumulative
    sum is exact in f32 and the chunkings differ only in summation order
    (with arbitrary floats the chunk-256 exponents, sums near 128, carry
    rounding of about 1e-5 relative in either package)."""
    x, _, _, B, Cm = _ssd_inputs(1, 256, 3, 4, 3, 1.0)
    dt = (RNG.integers(2, 7, (1, 256, 3)) / 8).astype(np.float32)
    A = np.array([-0.5, -1.0, -2.0], np.float32)
    args = (x, dt, A, B, Cm)
    jy256, _ = _ssd(JSSM, jnp.asarray, args, 256)
    assert np.isnan(jy256).any()
    jy16, jS16 = _ssd(JSSM, jnp.asarray, args, 16)
    assert np.all(np.isfinite(jy16))
    ty256, tS256 = _ssd(TSSM, torch.from_numpy, args, 256)
    assert np.all(np.isfinite(ty256))
    np.testing.assert_allclose(ty256, jy16, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tS256, jS16, rtol=1e-5, atol=1e-6)
    # where the reference's own chunk-256 rows are finite, the same values
    ok = np.isfinite(jy256)
    assert 0 < ok.mean() < 1
    np.testing.assert_allclose(ty256[ok], jy256[ok], rtol=1e-5, atol=1e-6)


def test_mamba2_trains_at_its_published_chunk():
    """mamba2-2.7b's published ssm_chunk 256 on one reduced-width layer
    with dt at its init's upper end: a finite loss and finite gradients."""
    cfg = TC.get("mamba2-2.7b").reduced(num_layers=1, ssm_chunk=256,
                                        compute_dtype="float32")
    params = treg.init_params(cfg, 0, "cpu")
    params["dt_bias"] = torch.full_like(params["dt_bias"], 2.0)
    params["A_log"] = torch.full_like(params["A_log"], 2.7)   # A = -15
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    batch = device_batch(SyntheticStream(cfg, 1, 256).batch_at(0), "cpu")
    loss = treg.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("family", ["dense-gelu2", "moe-residual", "ssm",
                                    "hybrid", "audio", "vlm", "vit"])
def test_shadow_checkpoint_is_bitwise_the_trainer(family):
    """train() through an in-process channel into a 2-node shadow, with a
    failure at step 2: no step lost, and the consolidated checkpoint
    bitwise the trainer's params, mu and nu."""
    _, cfg = _configs(family, microbatches=2)
    state, stats = train(cfg, steps=3, batch=4, seq=16,
                         channel=InProcessChannel(), shadow_nodes=2,
                         failure_plan=FailurePlan((2,)), device="cpu")
    shadow = stats.checkpointer.shadow
    ckpt = shadow.consolidate(timeout=30)
    shadow.shutdown()
    assert stats.recovered_at == [1] and stats.steps == 3
    assert all(np.isfinite(stats.losses))
    assert ckpt["step"] == state.step == 3
    for tree in ("params", "mu", "nu"):
        ours = getattr(state, tree)
        assert set(ckpt[tree]) == set(ours)
        for k, t in ours.items():
            assert torch.equal(ckpt[tree][k], t), f"{tree}[{k}]"
