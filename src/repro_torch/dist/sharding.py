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

The port has no tensor-parallel layers: the ranks of a ``model`` group
compute every layer whole, replicated, so ``local()`` holds a dim mapped
to ``model`` (or ``stage``) whole and cuts only dims mapped to dp axes.
``spec()`` and ``sharding().spec`` stay the reference's; the numbers are
the same, only the memory per rank differs (tensor-parallel layers are a
ROADMAP item of their own).
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
        """The process group over ``axes`` (a name, or a tuple of names
        that is one axis or every dp axis); None on a one-rank mesh."""
        axes = _axes(axes)
        if len(axes) == 1:
            return self.group(axes[0])
        if axes != dp_axes(self):
            raise ValueError(f"no process group over {axes}: one axis or "
                             f"the dp axes {dp_axes(self)}")
        if self.device_mesh is None:
            return None
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
    rank's slice, collectively over the ranks that split it. Only dims
    mapped to dp axes are cut (the module docstring says why); ``dim`` is
    that dim (None where nothing is cut) and ``axes`` its mesh axes.
    """

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)
        self.dim, self.axes = None, ()
        for d, part in enumerate(self.spec):
            axes = () if part is None else _axes(part)
            cut = tuple(a for a in axes if a not in _NON_DP_MESH_AXES)
            if not cut:
                continue
            if cut != axes or self.dim is not None:
                raise ValueError(f"spec {self.spec}: one dim may be cut, "
                                 f"over dp axes only")
            self.dim, self.axes = d, cut
        self.n = math.prod(mesh.shape[a] for a in self.axes)

    def local_shape(self, shape) -> tuple:
        shape = list(shape)
        if self.n > 1:
            if shape[self.dim] % self.n:
                raise ValueError(f"dim {self.dim} of {tuple(shape)} does "
                                 f"not split over {self.n} ranks")
            shape[self.dim] //= self.n
        return tuple(shape)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return x
        s = self.local_shape(x.shape)[self.dim]
        return x.narrow(self.dim, self.mesh.coordinate(self.axes) * s, s)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return local
        return torch.cat(self.mesh.all_gather(local, self.axes),
                         dim=self.dim)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


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

    def sharding(self, *logical, dims=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(*logical, dims=dims))

    def shard(self, x, *logical):
        """This rank's slice of the full tensor ``x`` under its logical
        spec (``x`` itself where the spec cuts nothing, as on one rank)."""
        return self.sharding(*logical, dims=x.shape).local(x)


def make_smoke_mesh(device=None) -> Mesh:
    """The one-rank ("data", "model") mesh, extents (1, 1), on ``device``
    (the card unless the caller asks for the CPU)."""
    return Mesh((1, 1), ("data", "model"), device=device)
