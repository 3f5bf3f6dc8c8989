"""Logical-axis sharding rules, the port of ``repro.dist.sharding``.

Model code never names mesh axes. Parameter specs use *logical* axis names
("batch", "heads", "act_ff", ...) and this module resolves them against a
named mesh:

=================  ==========================  ============================
logical axes       physical axes               used by
=================  ==========================  ============================
batch              data axes (pod, data)       activations / inputs
vocab, heads,      model                       tensor-parallel weight dims
kv_heads, ff,
ssm_inner, expert
act_heads, act_ff,  model                      tensor-parallel activations
act_vocab,
act_expert, kv_seq
wemb               fsdp ? data axes : none     the d_model weight dim
everything else    none (replicated)           norms, layers, seq, emb, ...
=================  ==========================  ============================

``fsdp=True`` flips the ``wemb`` weight dim to dp-sharded while keeping
the same logical specs — the elastic drills restore one layout onto the
other. A logical dim shards only when its size divides the mapped axes'
extent; otherwise it falls back to replicated, so the same specs resolve
on the one-rank smoke mesh and on a 16x16 production mesh.

The port's `Mesh` is a named shape over ranks, one process per rank. A
world of one rank holds no process group; a larger mesh holds a
`torch.distributed.device_mesh.DeviceMesh` whose per-axis groups the
explicit collectives (`repro_torch.dist.collectives`,
`repro_torch.dist.pipeline`) run over, and one group over all its dp axes
together. ``sharding()`` returns a `NamedSharding`, a (mesh, spec) pair
whose ``local(x)`` cuts a full tensor to the slice this rank holds and
whose ``gather(local)`` rebuilds the full tensor over the ranks that hold
its slices; ``shard(x, ...)`` takes a full tensor and returns its slice.
A dim mapped to several dp axes (``("pod", "data")``) splits row-major,
pod first, as JAX splits it.

Tensor-parallel families (`repro_torch.models.registry.TENSOR_PARALLEL`:
dense and vlm) hold what the reference's GSPMD holds: a dim mapped to
``model`` is cut over the rank's model group, independently of a dim cut
over the dp axes, so a ZeRO-1 leaf (``zero1_spec`` puts dp on a second
dim) is cut twice. Their layers run the explicit collectives of
`repro_torch.dist.tensor_parallel` over ``mesh.group("model")``. Every
other family, and serving, computes each layer whole on every rank of a
``model`` group: ``sharding(..., model=False)`` holds a ``model`` dim
whole and cuts only the dp dim. ``spec()`` and ``sharding().spec`` are the
reference's either way.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve

# Logical names that map to the tensor-parallel ("model") axis. Weight dims
# and activation dims are listed together: they resolve identically.
_MODEL_AXES = frozenset({
    "vocab", "heads", "kv_heads", "ff", "ssm_inner", "expert",       # weights
    "act_vocab", "act_heads", "act_ff", "act_expert", "kv_seq",      # acts
})

# Logical names that map to the data-parallel axes.
_DATA_AXES = frozenset({"batch"})

# Weight dims that become dp-sharded under FSDP (replicated otherwise).
_FSDP_AXES = frozenset({"wemb"})

# Mesh axes that are NOT data-parallel (everything else contributes to DP).
_NON_DP_MESH_AXES = ("model", "stage")


class P(tuple):
    """A partition spec: one entry per array dim, each None (replicated),
    a mesh axis name, or a tuple of names. A one-name tuple is stored as
    the name, as ``jax.sharding.PartitionSpec`` stores it; trailing Nones
    are kept as given (``ShardingRules.spec`` drops its own)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Named mesh axes over ranks.

    ``shape`` maps each axis name to its extent, in mesh order (as a JAX
    mesh's ``.shape``); ``ranks`` are the global ranks that fill it,
    row-major. ``device_mesh`` is the process-group mesh behind a mesh of
    more than one rank (a one-rank mesh needs none); ``coords`` is this
    rank's coordinate on each axis, or None on a rank outside the mesh.
    """

    def __init__(self, shape: tuple, axis_names: tuple, device=None,
                 device_mesh=None, ranks=None, groups=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.device = resolve(device)
        self.device_type = self.device.type
        if self.size > 1 and device_mesh is None:
            raise ValueError(f"a mesh of {self.size} ranks needs a "
                             f"DeviceMesh over an initialised process group")
        self.device_mesh = device_mesh
        self.ranks = list(range(self.size)) if ranks is None else list(ranks)
        coord = (device_mesh.get_coordinate() if device_mesh is not None
                 else (0,) * len(self.axis_names))
        self.coords = (None if coord is None
                       else dict(zip(self.axis_names, coord)))
        # the group over all dp axes together (where there are several)
        # and the group over every rank of the mesh
        self._groups = dict(groups or {})

    @classmethod
    def over_ranks(cls, shape: tuple, axis_names: tuple, ranks=None,
                   device=None) -> "Mesh":
        """The mesh of ``shape`` over ``ranks`` of the default process
        group (default: the first ``prod(shape)``, ascending), row-major.
        A mesh of one rank outside an initialised group holds no
        DeviceMesh.

        Where a group is up this is collective: every rank of the default
        group calls it, a rank outside ``ranks`` too (it builds the
        mesh's process groups with the others, then holds ``coords``
        None), and in the same order as the others.
        """
        n = math.prod(shape)
        ranks = list(range(n)) if ranks is None else list(ranks)
        if len(ranks) != n:
            raise ValueError(f"mesh {shape} over {len(ranks)} ranks")
        if ranks != sorted(set(ranks)):
            raise ValueError(f"mesh ranks must ascend: {ranks}")
        device = resolve(device)
        dm, groups = None, {}
        if dist.is_available() and dist.is_initialized():
            from torch.distributed.device_mesh import DeviceMesh
            grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
            dm = DeviceMesh(device.type, grid, mesh_dim_names=tuple(axis_names))
            me = dist.get_rank()
            dp = [i for i, a in enumerate(axis_names)
                  if a not in _NON_DP_MESH_AXES]
            if len(dp) > 1:
                other = [i for i in range(len(shape)) if i not in dp]
                rows = grid.permute(other + dp).reshape(
                    -1, math.prod(shape[i] for i in dp)).tolist()
                for row in rows:
                    g = dist.new_group(row)
                    if me in row:
                        groups["dp"] = g
            if ranks == list(range(dist.get_world_size())):
                groups["all"] = dist.group.WORLD
            else:
                g = dist.new_group(ranks)
                if me in ranks:
                    groups["all"] = g
        return cls(shape, axis_names, device=device, device_mesh=dm,
                   ranks=ranks, groups=groups)

    @property
    def is_member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return self.coords is not None

    def group(self, axis: str):
        """The process group along ``axis`` (None on a one-rank mesh)."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r}: {self.axis_names}")
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def group_over(self, axes):
        """The process group over ``axes`` (a name, a tuple of names that
        is one axis or every dp axis, or every axis of the mesh); None on
        a one-rank mesh."""
        axes = _axes(axes)
        if len(axes) == 1:
            return self.group(axes[0])
        if self.device_mesh is None:
            return None
        if set(axes) == set(self.axis_names):
            return self.mesh_group
        if axes != dp_axes(self):
            raise ValueError(f"no process group over {axes}: one axis, "
                             f"the dp axes {dp_axes(self)} or all axes")
        return self._groups["dp"]

    @property
    def mesh_group(self):
        """The process group of every rank of the mesh (None on a
        one-rank mesh outside an initialised group)."""
        return self._groups.get("all")

    def extent(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def coordinate(self, axes) -> int:
        """This rank's index over ``axes``, row-major (the first axis
        slowest), as JAX numbers a dim's slices over several axes."""
        if self.coords is None:
            raise ValueError(f"this rank is not in the mesh {self.ranks}")
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def all_gather(self, t: torch.Tensor, axes) -> list:
        """``t`` of every rank along ``axes``, in their index order."""
        parts = [torch.empty_like(t) for _ in range(self.extent(axes))]
        dist.all_gather(parts, t.contiguous(), group=self.group_over(axes))
        return parts

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device_type})"


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def dp_axes(mesh) -> tuple[str, ...]:
    """The mesh axes gradients are reduced over (in mesh order)."""
    return tuple(a for a in mesh.axis_names if a not in _NON_DP_MESH_AXES)


def dp_size(mesh) -> int:
    """Total data-parallel extent (the gradient-averaging world size)."""
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


class NamedSharding:
    """A partition spec on a mesh: the port's ``jax.sharding.NamedSharding``.

    ``local(x)`` is the slice of a full tensor ``x`` this rank holds (a
    view of ``x``); ``gather(local)`` rebuilds the full tensor from every
    rank's slice, collectively over the ranks that split it. One dim may
    be cut over the dp axes (``dim``, its mesh axes ``axes``, ``n`` ranks)
    and, independently, one over ``model`` (``model_dim``, ``m`` ranks);
    with ``model=False`` a ``model`` dim is held whole (the layout of a
    family that computes each layer whole on every model rank).
    ``dp_local`` and ``gather_dp`` are the dp half alone, on a tensor
    already cut over ``model``.
    """

    def __init__(self, mesh, spec, model: bool = True):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)
        self.dim, self.axes, self.model_dim = None, (), None
        for d, part in enumerate(self.spec):
            axes = () if part is None else _axes(part)
            if axes == ("model",):
                if model:
                    self.model_dim = d
                continue
            cut = tuple(a for a in axes if a not in _NON_DP_MESH_AXES)
            if not cut:
                continue
            if cut != axes or self.dim is not None:
                raise ValueError(f"spec {self.spec}: one dim may be cut "
                                 f"over dp axes and one over model")
            self.dim, self.axes = d, cut
        self.n = math.prod(mesh.shape[a] for a in self.axes)
        self.m = 1 if self.model_dim is None else mesh.shape["model"]

    def _cuts(self):
        return [(d, k, ax) for d, k, ax in ((self.dim, self.n, self.axes),
                                           (self.model_dim, self.m,
                                            ("model",)))
                if k > 1]

    def local_shape(self, shape) -> tuple:
        shape = list(shape)
        for d, k, _ in self._cuts():
            if shape[d] % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split over {k} ranks")
            shape[d] //= k
        return tuple(shape)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        for d, k, ax in self._cuts():
            s = x.shape[d] // k
            x = x.narrow(d, self.mesh.coordinate(ax) * s, s)
        return x

    def dp_local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's dp slice of ``x``, a tensor already cut over
        ``model`` (or holding no model cut)."""
        if self.n == 1:
            return x
        s = x.shape[self.dim] // self.n
        return x.narrow(self.dim, self.mesh.coordinate(self.axes) * s, s)

    def gather_dp(self, local: torch.Tensor) -> torch.Tensor:
        """The way back from `dp_local`, over this rank's dp group."""
        if self.n == 1:
            return local
        return torch.cat(self.mesh.all_gather(local, self.axes),
                         dim=self.dim)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        cuts = self._cuts()
        if not cuts:
            return local
        if len(cuts) == 1:
            d, _, ax = cuts[0]
            return torch.cat(self.mesh.all_gather(local, ax), dim=d)
        # cut twice: one all-gather over every axis, each rank's slice
        # placed by its (dp, model) coordinates
        names = self.mesh.axis_names
        if set(self.axes) | {"model"} != set(names):
            raise ValueError(f"spec {self.spec}: a leaf cut twice needs a "
                             f"mesh of only dp axes and model, not {names}")
        parts = self.mesh.all_gather(local, names)
        extents = [self.mesh.shape[a] for a in names]
        rows = [[None] * self.m for _ in range(self.n)]
        for r, t in enumerate(parts):
            c = dict(zip(names, (int(i) for i in unravel(r, extents))))
            i = 0
            for a in self.axes:
                i = i * self.mesh.shape[a] + c[a]
            rows[i][c["model"]] = t
        return torch.cat([torch.cat(row, dim=self.model_dim)
                          for row in rows], dim=self.dim)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def unravel(i: int, extents) -> list:
    """The row-major coordinates of index ``i`` on a grid of ``extents``
    (a mesh rank's on each axis, in mesh order)."""
    out = []
    for e in reversed(extents):
        out.append(i % e)
        i //= e
    return out[::-1]


class ShardingRules:
    """Resolve logical axis names to partition specs on a named mesh."""

    def __init__(self, mesh, fsdp: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp

    # -- resolution ----------------------------------------------------------
    def physical_axes(self, logical) -> tuple[str, ...]:
        """Mesh axes a logical name maps to (may be empty)."""
        if logical in _DATA_AXES:
            return dp_axes(self.mesh)
        if logical in _MODEL_AXES and "model" in self.mesh.axis_names:
            return ("model",)
        if logical in _FSDP_AXES and self.fsdp:
            return dp_axes(self.mesh)
        return ()

    def axis_size(self, logical) -> int:
        """Extent of the mesh axes behind a logical name (1 if unmapped)."""
        return math.prod(
            (self.mesh.shape[a] for a in self.physical_axes(logical)), start=1)

    def spec(self, *logical, dims=None) -> P:
        """Partition spec for one array's logical axes.

        ``dims`` (the array shape) enables the divisibility fallback and the
        rule that a physical axis is used at most once per spec.
        """
        parts: list = []
        used: set[str] = set()
        for i, name in enumerate(logical):
            axes = self.physical_axes(name) if name is not None else ()
            if any(a in used for a in axes):
                axes = ()               # a physical axis may appear only once
            if axes and dims is not None:
                extent = math.prod(self.mesh.shape[a] for a in axes)
                if dims[i] % extent:
                    axes = ()           # uneven chunks: replicate this dim
            if axes:
                used.update(axes)
                parts.append(axes if len(axes) > 1 else axes[0])
            else:
                parts.append(None)
        while parts and parts[-1] is None:
            parts.pop()                 # trailing Nones are implicit
        return P(*parts)

    def sharding(self, *logical, dims=None, model: bool = True
                 ) -> NamedSharding:
        """The `NamedSharding` of ``spec``; ``model=False`` holds a
        ``model`` dim whole."""
        return NamedSharding(self.mesh, self.spec(*logical, dims=dims),
                             model=model)

    def shard(self, x, *logical):
        """This rank's slice of the full tensor ``x`` under its logical
        spec (``x`` itself where the spec cuts nothing, as on one rank)."""
        return self.sharding(*logical, dims=x.shape).local(x)


def make_smoke_mesh(device=None) -> Mesh:
    """The one-rank ("data", "model") mesh, extents (1, 1), on ``device``
    (the card unless the caller asks for the CPU)."""
    return Mesh((1, 1), ("data", "model"), device=device)
