"""The port's serving path of the ssm, hybrid and audio families against
the JAX package's, on the CPU (tests/test_torch_serve.py holds the others,
and the helpers and tolerances used here): the SSM's decode cores
(``conv_step``, ``ssd_decode_step``, ``mamba_decode_block``) to rtol 1e-5
at f32, and each family's prefill, caches and greedy decode from the
reference's carried-over cache, and its prefill + decode against its own
forward.

Prompts are at least ``ssm_conv - 1`` tokens long: the conv caches hold
that many pre-conv rows, and a shorter prompt's tail is shorter than the
cache (in the reference too).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.configs as C
from repro.models import ssm as JSSM

from repro_torch import configs as TC
from repro_torch.convert import to_numpy, to_tensor
from repro_torch.models import ssm as TSSM

from test_torch_serve import (check_decode_matches_forward,
                              check_serving_matches_jax, rules)  # noqa: F401

torch.set_num_threads(2)   # leave cores to the other test workers

RNG = np.random.default_rng(23)
TOL = dict(rtol=1e-5, atol=1e-6)


def _f32(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def test_conv_step_matches_jax():
    b, w, c = 2, 4, 6
    x_t, cache, kern = _f32(b, c), _f32(b, w - 1, c), _f32(w, c)
    jy, jc = JSSM.conv_step(jnp.asarray(x_t), jnp.asarray(cache),
                            jnp.asarray(kern))
    ty, tc = TSSM.conv_step(torch.as_tensor(x_t), torch.as_tensor(cache),
                            torch.as_tensor(kern))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_conv_steps_continue_the_causal_conv():
    """Conv steps from a prompt's pre-conv tail give the causal conv of
    the whole sequence at the following positions."""
    b, s, c, w = 2, 10, 3, 4
    x, kern = torch.as_tensor(_f32(b, s, c)), torch.as_tensor(_f32(w, c))
    full = TSSM.causal_conv(x, kern)
    cache = x[:, 6 - (w - 1):6]
    for t in range(6, s):
        y, cache = TSSM.conv_step(x[:, t], cache, kern)
        np.testing.assert_allclose(y.numpy(), full[:, t].numpy(), **TOL)


def test_ssd_decode_step_matches_jax():
    b, h, p, n = 2, 3, 4, 5
    x_t, B_t, C_t = _f32(b, h, p), _f32(b, n), _f32(b, n)
    dt = np.abs(_f32(b, h)) * 0.1
    A = -np.abs(_f32(h))
    S = _f32(b, h, n, p)
    jy, jS = JSSM.ssd_decode_step(*(jnp.asarray(a)
                                    for a in (x_t, dt, A, B_t, C_t, S)))
    ty, tS = TSSM.ssd_decode_step(*(torch.as_tensor(a)
                                    for a in (x_t, dt, A, B_t, C_t, S)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), **TOL)


def test_mamba_decode_block_matches_jax(rules):  # noqa: F811
    from repro.models import registry as jreg
    import jax
    jcfg = C.get("mamba2-2.7b").reduced(compute_dtype="float32")
    tcfg = TC.get("mamba2-2.7b").reduced(compute_dtype="float32")
    jparams = jreg.init_params(jax.random.PRNGKey(5), jcfg, rules)
    jlp = {k: jparams[k][0] for k in JSSM.SSM_LAYER_KEYS}
    tlp = {k: to_tensor(np.asarray(v)) for k, v in jlp.items()}
    b, w = 2, jcfg.ssm_conv
    x = _f32(b, 1, jcfg.d_model)
    state = _f32(b, jcfg.ssm_heads, jcfg.ssm_state, jcfg.ssm_head_dim,
                 scale=0.1)
    conv = {"x": _f32(b, w - 1, jcfg.d_inner),
            "B": _f32(b, w - 1, jcfg.ssm_state),
            "C": _f32(b, w - 1, jcfg.ssm_state)}
    jx, jS, jc = JSSM.mamba_decode_block(
        jnp.asarray(x), jlp, jnp.asarray(state),
        {k: jnp.asarray(v) for k, v in conv.items()}, jcfg, rules)
    tx, tS, tc = TSSM.mamba_decode_block(
        torch.as_tensor(x), tlp, torch.as_tensor(state),
        {k: torch.as_tensor(v) for k, v in conv.items()}, tcfg)
    np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), **TOL)
    np.testing.assert_allclose(to_numpy(tS), np.asarray(jS), **TOL)
    for k in conv:                      # the new rows are projections
        np.testing.assert_allclose(to_numpy(tc[k]), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio"])
def test_serving_matches_jax(family, rules):  # noqa: F811
    check_serving_matches_jax(family, rules)


@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio"])
def test_decode_matches_forward(family):
    check_decode_matches_forward(family)


def test_ssm_prompt_of_the_conv_width(rules):  # noqa: F811
    """The shortest prompt whose tail fills the conv cache (ssm_conv - 1
    tokens) serves as the reference does."""
    cfg = TC.get("mamba2-2.7b").reduced()
    check_serving_matches_jax("ssm", rules, prompt=cfg.ssm_conv - 1, steps=2)
