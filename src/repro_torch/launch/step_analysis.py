"""What one step costs one rank, read from the step itself run on meta
tensors: the port's stand-in for ``repro.launch.hlo_analysis
.analyze_compiled``, which walks XLA's optimized HLO and has no
counterpart here (nothing is compiled).

`analyze_step` runs ``fn(*args)`` once under `torch.utils.flop_counter
.FlopCounterMode` and a counting dispatch mode, with ``args`` on the
``meta`` device (the dry run's stand-ins) and, for a step over ranks, a
fake process group (`repro_torch.launch.mesh.fake_world`). The step runs
unchanged: every aten op, every c10d op and every kernel wrapper call it
makes is seen as it is issued. It returns the reference's keys:

- ``flops_per_device``: the products `FlopCounterMode` counts (matmuls,
  batched matmuls and einsums, forward, backward and the remat forward),
  plus the FLOPs each kernel wrapper records for its kernel on meta
  tensors (`repro_torch.kernels.build.record_work`: the flash forward's
  two products, its backward's five). Elementwise work is not counted, as `FlopCounterMode`
  counts none. ``flops_by_op`` splits its part by aten op (``"mm"``,
  ``"bmm"``, ...).
- ``bytes_per_device``: the bytes every aten op reads and writes (each
  tensor input and output once; views and ``empty`` move none), plus the
  bytes each kernel records. It is an upper bound for an unfused step:
  every op's output goes to memory and is read back by the next, which is
  what the port's plain PyTorch between the kernels does.
- ``collective_bytes_per_device`` and ``per_collective``: the operand
  bytes of every c10d op, by op name as the dispatch sees it (the ring
  shows as ``send`` and ``recv_``, the loss as ``allreduce_``, an FSDP
  gather as ``allgather_``). A ``recv_`` is the other end of a ``send``:
  it is listed, and left out of the total, which counts the bytes this
  rank puts on the wire.
- ``memory``: ``argument_bytes`` (the distinct storages of ``args``: the
  local state and inputs), ``output_bytes`` (of the result) and
  ``alias_bytes`` (the part of the result that is an argument updated in
  place), and ``temp_bytes``: the peak, over the step, of the bytes of
  storages the step allocated and still holds (each storage tracked from
  the op that makes it to its release, by a weakref finalizer).

Nothing reads a value back to the host on meta: a step that does (a
gradient clip turns the norm into a host float) raises where it does.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import build

# c10d ops (those torch.distributed's collectives issue) whose first
# argument is the output: their operand is the second
_OUTPUT_FIRST = frozenset({
    "allgather_", "_allgather_base_", "reduce_scatter_",
    "_reduce_scatter_base_", "alltoall_", "alltoall_base_", "gather_",
    "scatter_"})
# the receiving end of a point-to-point send
_RECEIVES = frozenset({"recv_", "recv_any_source_"})


def _tensors(tree) -> list:
    """Every tensor in ``tree`` (dicts, lists, tuples, dataclasses)."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out += _tensors([getattr(x, f.name)
                             for f in dataclasses.fields(x)])
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(ts) -> int:
    """Bytes of the distinct storages behind ``ts``."""
    seen = {}
    for t in ts:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class _Counter(TorchDispatchMode):
    """Bytes by op, collectives by c10d op, and live storages."""

    def __init__(self, arguments):
        super().__init__()
        self.bytes = 0.0
        self.per_collective = defaultdict(float)
        self.collective_bytes = 0.0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in arguments:
            self._seen[t.untyped_storage()] = True

    def _release(self, n: int):
        self.live -= n

    def _track(self, outs, ins):
        """Count each storage among ``outs`` that no input holds and that
        was not seen before: one the op allocated."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in held or st in self._seen:
                continue
            self._seen[st] = True
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        if func.namespace == "c10d":
            operand = args[1] if name in _OUTPUT_FIRST else args[0]
            n = sum(_nbytes(t) for t in _tensors(operand))
            self.per_collective[name] += n
            if name not in _RECEIVES:
                self.collective_bytes += n
            self.bytes += n
            return out
        outs = _tensors(out)
        if not func.is_view and not name.startswith(("empty", "new_empty")):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._track(outs, ins)
        return out


def analyze_step(fn, *args) -> dict:
    """Run ``fn(*args)`` once on meta tensors and return what it costs
    this rank (the module docstring gives each key). ``result`` holds what
    ``fn`` returned and ``kernels`` the work each kernel wrapper recorded:
    ``{name: {"calls", "flops", "bytes"}}``."""
    arguments = _tensors(args)
    if any(t.device.type != "meta" for t in arguments):
        raise ValueError("analyze_step: every tensor argument must be on "
                         "the meta device")
    kernels = defaultdict(lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})

    def sink(kernel, flops, nbytes):
        k = kernels[kernel]
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    counter = _Counter(arguments)
    flops = FlopCounterMode(display=False)
    build._work_sinks.append(sink)
    try:
        with flops, counter:
            try:
                result = fn(*args)
            except RuntimeError as e:
                if "cannot be called on meta tensors" not in str(e):
                    raise
                raise RuntimeError(
                    f"analyze_step: the step reads a value back to the "
                    f"host, which a meta tensor does not have (a gradient "
                    f"clip does: OptimizerConfig(grad_clip=0) keeps the "
                    f"step on the device): {e}") from e
    finally:
        build._work_sinks.remove(sink)
    outputs = _tensors(result)
    arg_ids = {id(t.untyped_storage()) for t in arguments}
    return {
        "flops_per_device": float(flops.get_total_flops())
        + sum(k["flops"] for k in kernels.values()),
        "flops_by_op": {op.__name__.split(".")[0]: int(n) for op, n in
                        flops.get_flop_counts()["Global"].items()},
        "bytes_per_device": counter.bytes
        + sum(k["bytes"] for k in kernels.values()),
        "collective_bytes_per_device": counter.collective_bytes,
        "per_collective": dict(counter.per_collective),
        "memory": {
            "argument_bytes": _storage_bytes(arguments),
            "output_bytes": _storage_bytes(outputs),
            "temp_bytes": counter.peak,
            "alias_bytes": _storage_bytes(
                [t for t in outputs if id(t.untyped_storage()) in arg_ids]),
        },
        "kernels": {k: dict(v) for k, v in kernels.items()},
        "result": result,
    }
