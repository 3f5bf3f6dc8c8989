"""The port's sharding rules and ZeRO-1 specs against the JAX package's.

`repro_torch.dist.sharding.ShardingRules` and
`repro_torch.optim.sharded.zero1_spec` are pure shape logic over a named
mesh, so both packages run on the same stand-in mesh (the reference's
``_FakeMesh`` of tests/test_optim.py: ``shape`` and ``axis_names`` only)
at the smoke, a small, the production and the multi-pod extents, with FSDP
off and on. For every ParamSpec of every config the two specs must be the
same tuple of mesh axes.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP

import repro.configs as C
from repro.dist.sharding import ShardingRules as JRules
from repro.dist.sharding import dp_axes as j_dp_axes
from repro.dist.sharding import dp_size as j_dp_size
from repro.models import registry as JR
from repro.optim.sharded import zero1_spec as j_zero1_spec

from repro_torch import configs as TC
from repro_torch.dist.sharding import (P, Mesh, ShardingRules, dp_axes,
                                       dp_size, make_smoke_mesh)
from repro_torch.models import registry as TR
from repro_torch.optim.sharded import zero1_shardings, zero1_spec


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


class _FakeRank(_FakeMesh):
    """Rank ``rank`` of a stand-in mesh, row-major: its coordinates, and
    an ``all_gather`` that returns the slices in ``peers`` of the ranks
    that differ from it only along the gathered axes."""

    def __init__(self, shape, rank):
        super().__init__(shape)
        self.rank = rank
        self.coords = dict(zip(self.axis_names, np.unravel_index(
            rank, tuple(shape.values()))))
        self.peers = {}

    def extent(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def coordinate(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + int(self.coords[a])
        return i

    def all_gather(self, t, axes):
        dims = tuple(self.shape.values())
        out = []
        for r in range(int(np.prod(dims))):
            c = dict(zip(self.axis_names, np.unravel_index(r, dims)))
            if all(c[a] == self.coords[a] for a in self.axis_names
                   if a not in axes):
                out.append((tuple(int(c[a]) for a in axes), self.peers[r]))
        return [t for _, t in sorted(out, key=lambda e: e[0])]


MESHES = {
    "1x1": {"data": 1, "model": 1},
    "4x2": {"data": 4, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
ARCHS = sorted(TC.ASSIGNED + TC.PAPER)


def _specs(arch):
    t, j = TR.param_specs(TC.get(arch)), JR.param_specs(C.get(arch))
    assert set(t) == set(j)
    for k, ps in t.items():
        assert (tuple(ps.shape), tuple(ps.logical)) == \
            (tuple(j[k].shape), tuple(j[k].logical)), k
    return t, j


def test_every_config_is_covered():
    assert len(ARCHS) == 15 and set(ARCHS) == set(C.ASSIGNED + C.PAPER)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh, fsdp):
    m = _FakeMesh(MESHES[mesh])
    t, j = _specs(arch)
    tr, jr = ShardingRules(m, fsdp=fsdp), JRules(m, fsdp=fsdp)
    for k, ps in t.items():
        got = tr.spec(*ps.logical, dims=ps.shape)
        assert isinstance(got, P)
        assert tuple(got) == tuple(jr.spec(*j[k].logical,
                                           dims=j[k].shape)), k


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_match_jax(arch, mesh, fsdp):
    m = _FakeMesh(MESHES[mesh])
    t, j = _specs(arch)
    jr = JRules(m, fsdp=fsdp)
    got = zero1_shardings(t, ShardingRules(m, fsdp=fsdp))
    assert set(got) == set(t)
    for k, ps in j.items():
        want = j_zero1_spec(ps.shape, jr.spec(*ps.logical, dims=ps.shape), m)
        assert tuple(got[k]) == tuple(want), k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_axes_size_and_axis_size_match_jax(mesh):
    m = _FakeMesh(MESHES[mesh])
    assert dp_axes(m) == j_dp_axes(m)
    assert dp_size(m) == j_dp_size(m)
    for fsdp in (False, True):
        tr, jr = ShardingRules(m, fsdp=fsdp), JRules(m, fsdp=fsdp)
        for name in ("batch", "heads", "act_ff", "kv_seq", "wemb", "emb",
                     "layers", None):
            assert tr.physical_axes(name) == jr.physical_axes(name), name
            assert tr.axis_size(name) == jr.axis_size(name), name


@given(st.tuples(st.integers(1, 8).map(lambda x: x * 16),
                 st.integers(1, 64)))
@settings(max_examples=30, deadline=None)
def test_zero1_spec_picks_divisible_dim(shape):
    mesh = _FakeMesh({"data": 16, "model": 16})
    spec = zero1_spec(shape, P(), mesh)
    placed = [i for i, s in enumerate(spec) if s is not None]
    if placed:
        (i,) = placed
        assert shape[i] % 16 == 0
    assert tuple(spec) == tuple(j_zero1_spec(shape, JP(), mesh))


def test_zero1_spec_no_duplicate_axes():
    mesh = _FakeMesh({"data": 16, "model": 16})
    # fsdp leaf already sharded over data -> zero1 must not re-use it
    spec = zero1_spec((32, 64), P(("data",), "model"), mesh)
    assert spec == P(("data",), "model") == ("data", "model")
    # TP-only leaf gets data on the free divisible dim
    spec = zero1_spec((32, 64), P(None, "model"), mesh)
    assert spec == P("data", "model")
    # nothing divisible -> untouched, one entry per dim
    spec = zero1_spec((3, 5), P(), mesh)
    assert spec == P(None, None)
    assert tuple(j_zero1_spec((3, 5), JP(), mesh)) == (None, None)


def test_spec_fallback_and_one_use_of_an_axis():
    r = ShardingRules(_FakeMesh({"pod": 2, "data": 16, "model": 16}),
                      fsdp=True)
    # both dims want the dp axes: only the first takes them
    assert r.spec("batch", "wemb", dims=(64, 64)) == P(("pod", "data"))
    # 24 does not divide by 32: replicated, and the trailing None dropped
    assert r.spec("wemb", "ff", dims=(24, 32)) == P(None, "model")
    assert r.spec("emb", "layers") == P()
    assert repr(P("data", None)) == "P('data', None)"


def test_smoke_mesh_and_shard():
    mesh = make_smoke_mesh("cpu")
    assert (mesh.axis_names, mesh.shape, mesh.size, mesh.device_type) == \
        (("data", "model"), {"data": 1, "model": 1}, 1, "cpu")
    assert mesh.group("data") is None and mesh.device_mesh is None
    with pytest.raises(KeyError):
        mesh.group("stage")
    rules = ShardingRules(mesh)
    assert dp_size(mesh) == 1 and rules.axis_size("batch") == 1
    x = torch.arange(6.0).reshape(2, 3)
    assert rules.shard(x, "batch", "emb") is x
    # on a 4 x 2 mesh each rank's local() is its dp slice and its model
    # slice (with model=False its dp slice alone, the model dim whole),
    # and gather() over the ranks that split it rebuilds the tensor
    y = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    ranks = [_FakeRank({"data": 4, "model": 2}, r) for r in range(8)]

    def cut(t, d, n, i):
        return t if d is None else t.narrow(d, i * t.shape[d] // n,
                                            t.shape[d] // n)
    for fsdp, logical, spec, dim, mdim in (
            (False, ("batch", "heads", None), P("data", "model"), 0, 1),
            (True, ("heads", "wemb"), P("model", "data"), 1, 0),
            (False, ("heads", "wemb"), P("model"), None, 0)):
        for model in (True, False):
            shs = [ShardingRules(m, fsdp=fsdp).sharding(
                *logical, dims=y.shape, model=model) for m in ranks]
            for m, sh in zip(ranks, shs):
                assert sh.spec == spec and sh.dim == dim
                assert sh.model_dim == (mdim if model else None)
                dp_part = cut(y, dim, 4, m.coords["data"])
                want = (cut(dp_part, mdim, 2, m.coords["model"]) if model
                        else dp_part)
                got = sh.local(y)
                assert torch.equal(got, want)
                if model:
                    assert torch.equal(ShardingRules(m, fsdp=fsdp).shard(
                        y, *logical), want)
                assert sh.local_shape(y.shape) == tuple(want.shape)
            for m in ranks:
                m.peers = {p.rank: shs[p.rank].local(y) for p in ranks}
            for m, sh in zip(ranks, shs):
                assert torch.equal(sh.gather(sh.local(y)), y)
    # a mesh of more than one rank needs a process-group mesh behind it
    with pytest.raises(ValueError, match="DeviceMesh"):
        Mesh((2, 1), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_smoke_mesh()


def test_zero1_on_the_smoke_mesh_matches_jax_over_a_reduced_config():
    """On the (1, 1) mesh every dim divides: ZeRO-1 places "data" on each
    leaf's largest free dim, as the reference does."""
    m = make_smoke_mesh("cpu")
    cfg = TC.get("tinyllama-1.1b").reduced()
    got = zero1_shardings(TR.param_specs(cfg), ShardingRules(m))
    jr = JRules(_FakeMesh({"data": 1, "model": 1}))
    for k, ps in JR.param_specs(C.get("tinyllama-1.1b").reduced()).items():
        want = j_zero1_spec(ps.shape, jr.spec(*ps.logical, dims=ps.shape),
                            jr.mesh)
        assert tuple(got[k]) == tuple(want), k
        assert sum(p == "data" for p in got[k]) == 1
        i = list(got[k]).index("data")
        assert ps.shape[i] == max(d for d, p in zip(ps.shape, got[k])
                                  if p in (None, "data"))
    assert np.all([isinstance(s, P) for s in got.values()])
