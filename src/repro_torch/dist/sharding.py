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

The port's `Mesh` is a named shape over ranks. A world of one rank holds
no process group; a larger mesh holds a
`torch.distributed.device_mesh.DeviceMesh` whose per-axis groups the
explicit collectives (`repro_torch.dist.collectives`,
`repro_torch.dist.pipeline`) run over. Placing tensors by a spec on more
than one rank (``shard`` there, and the reference's ``sharding()``) is
ROADMAP item 11b: ``shard`` raises on such a mesh rather than ignore it.
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
    mesh's ``.shape``). ``device_mesh`` is the process-group mesh behind
    a mesh of more than one rank; a one-rank mesh needs none.
    """

    def __init__(self, shape: tuple, axis_names: tuple, device=None,
                 device_mesh=None):
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

    @classmethod
    def over_ranks(cls, shape: tuple, axis_names: tuple, ranks=None,
                   device=None) -> "Mesh":
        """The mesh of ``shape`` over ``ranks`` of the default process
        group (default: the first ``prod(shape)``), row-major. A mesh of
        one rank outside an initialised group holds no DeviceMesh."""
        n = math.prod(shape)
        ranks = list(range(n)) if ranks is None else list(ranks)
        if len(ranks) != n:
            raise ValueError(f"mesh {shape} over {len(ranks)} ranks")
        device = resolve(device)
        dm = None
        if dist.is_available() and dist.is_initialized():
            from torch.distributed.device_mesh import DeviceMesh
            dm = DeviceMesh(device.type,
                            torch.tensor(ranks, dtype=torch.int64)
                            .reshape(shape),
                            mesh_dim_names=tuple(axis_names))
        return cls(shape, axis_names, device=device, device_mesh=dm)

    def group(self, axis: str):
        """The process group along ``axis`` (None on a one-rank mesh)."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r}: {self.axis_names}")
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device_type})"


def dp_axes(mesh) -> tuple[str, ...]:
    """The mesh axes gradients are reduced over (in mesh order)."""
    return tuple(a for a in mesh.axis_names if a not in _NON_DP_MESH_AXES)


def dp_size(mesh) -> int:
    """Total data-parallel extent (the gradient-averaging world size)."""
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


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

    def shard(self, x, *logical):
        """The reference's ``with_sharding_constraint``: the identity on a
        one-rank mesh, as that is on one device."""
        if self.mesh.size > 1:
            raise NotImplementedError(
                f"placing a tensor by its logical spec on a mesh of "
                f"{self.mesh.size} ranks is ROADMAP item 11b")
        return x


def make_smoke_mesh(device=None) -> Mesh:
    """The one-rank ("data", "model") mesh, extents (1, 1), on ``device``
    (the card unless the caller asks for the CPU)."""
    return Mesh((1, 1), ("data", "model"), device=device)
