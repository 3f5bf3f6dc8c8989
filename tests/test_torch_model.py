"""The port's dense model against the JAX package's on tinyllama-1.1b
reduced, with the JAX package's initial weights carried over by
``repro_torch.convert``.

Tolerances: at f32 compute, loss and gradients to rtol 1e-4 (the two
frameworks sum in other orders); at bf16 compute, the loss to 2e-2 and the
gradients to 5e-2 in relative norm (bf16 rounds at other places in each).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as C
from repro.data.synthetic import SyntheticStream as JStream
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.models import layers as JL
from repro.models import registry as jreg

from repro_torch import configs as TC
from repro_torch.convert import to_numpy, to_tensor
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.models import layers as TL
from repro_torch.models import registry as treg

torch.set_num_threads(2)   # leave cores to the other test workers

RNG = np.random.default_rng(5)


@pytest.fixture(scope="module")
def rules():
    return ShardingRules(make_smoke_mesh())


def _configs(**over):
    return (C.get("tinyllama-1.1b").reduced(**over),
            TC.get("tinyllama-1.1b").reduced(**over))


def _jax_loss_and_grads(jparams, jcfg, rules, batch):
    cd = jnp.dtype(jcfg.compute_dtype)

    def loss(params):
        return jreg.loss_fn({k: p.astype(cd) for k, p in params.items()},
                            jcfg, rules, batch)
    return jax.value_and_grad(loss)(jparams)


def _port_loss_and_grads(jparams, tcfg, batch):
    cd = TORCH_DTYPES[tcfg.compute_dtype]
    params = {k: to_tensor(np.asarray(v)).requires_grad_(True)
              for k, v in jparams.items()}
    loss = treg.loss_fn({k: p.to(cd) for k, p in params.items()}, tcfg,
                        device_batch(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(rules, compute):
    jcfg, tcfg = _configs(compute_dtype=compute)
    jparams = jreg.init_params(jax.random.PRNGKey(3), jcfg, rules)
    batch = JStream(jcfg, 2, 32, seed=1).batch_at(0)
    assert all(np.array_equal(batch[k], v) for k, v in
               SyntheticStream(tcfg, 2, 32, seed=1).batch_at(0).items())
    jl, jg = _jax_loss_and_grads(jparams, jcfg, rules, batch)
    tl, tg = _port_loss_and_grads(jparams, tcfg, batch)
    assert set(tg) == set(jg)
    if compute == "float32":
        assert tl == pytest.approx(float(jl), rel=1e-4)
        for k in jg:
            np.testing.assert_allclose(to_numpy(tg[k]), np.asarray(jg[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    else:
        assert tl == pytest.approx(float(jl), rel=2e-2)
        for k in jg:
            a, b = to_numpy(tg[k]), np.asarray(jg[k], np.float32)
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
            assert rel < 5e-2, (k, rel)


def test_remat_does_not_change_grads():
    """Per-layer recompute gives the same gradients as keeping
    activations (the flash forward is deterministic)."""
    tcfg = TC.get("tinyllama-1.1b").reduced(compute_dtype="float32")
    from dataclasses import replace
    from repro_torch.train.step import make_train_state
    params = make_train_state(tcfg, seed=2, device="cpu").params
    batch = device_batch(SyntheticStream(tcfg, 2, 16).batch_at(0), "cpu")
    out = []
    for remat in (True, False):
        ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = treg.loss_fn(ps, replace(tcfg, remat=remat), batch)
        out.append(torch.autograd.grad(loss, list(ps.values())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_flash_attention_grads_match_jax_vjp(dtype, tol):
    b, s, h, kv, d = 2, 32, 4, 2, 16
    jdt = jnp.dtype(dtype)
    q = RNG.standard_normal((b, s, h, d)) * 0.5
    k = RNG.standard_normal((b, s, kv, d)) * 0.5
    v = RNG.standard_normal((b, s, kv, d))
    do = RNG.standard_normal((b, s, h, d))

    def jfn(q, k, v):
        o = JL.flash_attention_jnp(q, JL.expand_kv(k, h), JL.expand_kv(v, h),
                                   True, 0)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do, jnp.float32))
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jg = jax.grad(jfn, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (to_tensor(np.asarray(x)).requires_grad_(True)
                  for x in (jq, jk, jv))
    o = TL.FlashAttention.apply(tq, tk, tv, True)
    tg = torch.autograd.grad(
        (o.float() * torch.as_tensor(do, dtype=torch.float32)).sum(),
        (tq, tk, tv))
    for a, bj, name in zip(tg, jg, "qkv"):
        a, bj = to_numpy(a), np.asarray(bj, np.float32)
        rel = np.linalg.norm(a - bj) / np.linalg.norm(bj)
        assert rel < tol, (name, rel)


def test_rmsnorm_and_rope_match_jax():
    x = RNG.standard_normal((2, 8, 4, 16)).astype(np.float32)
    w = RNG.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    np.testing.assert_allclose(
        to_numpy(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        to_numpy(TL.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                         10_000.0)),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=1e-5, atol=1e-5)


def test_param_count_is_tinyllamas():
    assert TC.get("tinyllama-1.1b").param_count() == 1_100_048_384
