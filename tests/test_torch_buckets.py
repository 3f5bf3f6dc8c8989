"""The port's bucket layer against the JAX package's: the same named leaves
give the same layout and the same shadow-node ownership, field by field
(exact: this is integer bookkeeping)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as C
from repro.core import buckets as jb
from repro.core.multicast import assign_buckets as j_assign
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.models import registry as jreg

from repro_torch import configs as TC
from repro_torch.core import buckets as tb
from repro_torch.core.multicast import assign_buckets as t_assign
from repro_torch.models import registry as treg
from repro_torch.train.step import make_train_state

torch.set_num_threads(2)   # leave cores to the other test workers


def _fields(layout):
    return [(b.bucket_id, b.size, b.nbytes,
             [(s.name, s.offset, s.size, tuple(s.shape), s.dtype)
              for s in b.slots]) for b in layout.buckets]


@pytest.fixture(scope="module")
def jax_reduced_params():
    cfg = C.get("tinyllama-1.1b").reduced()
    rules = ShardingRules(make_smoke_mesh())
    return jreg.init_params(jax.random.PRNGKey(0), cfg, rules)


@pytest.mark.parametrize("cap", [tb.DEFAULT_BUCKET_BYTES, 4096, 1 << 16])
def test_reduced_tinyllama_layout_matches(jax_reduced_params, cap):
    port = make_train_state(TC.get("tinyllama-1.1b").reduced(), device="cpu")
    assert list(port.params) == list(jax_reduced_params)
    jl = jb.layout_for_tree(jax_reduced_params, cap_bytes=cap)
    tl = tb.layout_for_tree(port.params, cap_bytes=cap)
    assert _fields(tl) == _fields(jl)
    assert tl.total_bytes == jl.total_bytes
    for n in (1, 2, 3):
        assert t_assign(tl, n) == j_assign(jl, n)


def test_full_tinyllama_layout_matches_from_specs():
    """At full width (no allocation): the same names, shapes and dtypes in
    the same order give the same buckets."""
    js = jreg.param_specs(C.get("tinyllama-1.1b"))
    ts = treg.param_specs(TC.get("tinyllama-1.1b"))
    jl = jb.build_buckets([(k, js[k].shape, js[k].dtype) for k in sorted(js)])
    tl = tb.build_buckets([(k, ts[k].shape, ts[k].dtype) for k in sorted(ts)])
    assert _fields(tl) == _fields(jl)
    assert sum(b.size for b in tl.buckets) == 1_100_048_384
    for n in (1, 2, 4):
        assert t_assign(tl, n) == j_assign(jl, n)


def test_mixed_dtype_tree_layout_matches():
    rng = np.random.default_rng(3)
    spec = [("a", (300,), "float32"), ("b", (17, 9), "bfloat16"),
            ("c", (1000,), "bfloat16"), ("d", (64, 64), "float32"),
            ("e", (5,), "int32"), ("f", (2, 3), "float32")]
    jtree, ttree = {}, {}
    for name, shape, dt in spec:
        x = rng.standard_normal(shape) * 10
        jtree[name] = jnp.asarray(x, dt)
        ttree[name] = torch.as_tensor(x).to(tb.TORCH_DTYPES[dt])
    for cap in (tb.DEFAULT_BUCKET_BYTES, 2048, 8192):
        jl = jb.layout_for_tree(jtree, cap_bytes=cap)
        tl = tb.layout_for_tree(ttree, cap_bytes=cap)
        assert _fields(tl) == _fields(jl)
        for n in (1, 2, 3):
            assert t_assign(tl, n) == j_assign(jl, n)


def test_pack_unpack_roundtrip_and_flat_view():
    tree = {"x": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "y": torch.arange(5, dtype=torch.float32)}
    layout = tb.layout_for_tree(tree, cap_bytes=1 << 20)
    (bucket,) = layout.buckets
    flat = tb.pack_bucket_into(bucket, tree, tb.alloc_flat(bucket.size,
                                                           "float32"))
    back = tb.unpack_bucket(bucket, flat)
    view = tb.FlatTreeView(layout, {bucket.bucket_id: flat})
    assert sorted(view) == ["x", "y"] and len(view) == 2
    for k, t in tree.items():
        assert torch.equal(back[k], t)
        assert torch.equal(view[k], t)
    flat[0] = 99.0                     # a view, not a copy
    assert view["y"].reshape(-1)[0] == 99.0 or view["x"].reshape(-1)[0] == 99.0


def test_bucket_dtype_refuses_a_mixed_bucket():
    mixed = tb.Bucket(0, (tb.LeafSlot("a", 0, 2, (2,), "float32"),
                          tb.LeafSlot("b", 2, 2, (2,), "bfloat16")), 4)
    with pytest.raises(ValueError):
        tb.bucket_dtype(mixed)
