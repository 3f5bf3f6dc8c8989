"""Appendix A/B cost model: LLaMA-style FLOPs, iteration time, wasted
GPU-hours, optimal checkpoint frequency, and Checkmate savings — the port's
copy of ``repro.core.costmodel``, over the port's bucket layer, registry and
configs.

Reproduces Figure 1 (wasted GPU-hours vs checkpoint frequency), Figure 11
(savings vs scale / failure rate / overhead), and the §6.7 headline numbers.
Everything here is arithmetic on shapes: nothing allocates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Appendix A: FLOPs + iteration time
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LlamaDims:
    b: int          # batch size (sequences)
    s: int          # sequence length
    L: int          # layers
    h: int          # hidden dim
    f: int          # FFN dim
    v: int          # vocab
    a: int          # query heads
    g: int          # kv groups  (paper notation: K/V heads)


LLAMA3_405B = LlamaDims(b=2048, s=8192, L=126, h=16384, f=53248,
                        v=128256, a=128, g=8)


def forward_flops(d: LlamaDims) -> float:
    """Appendix A, component by component — the paper's formulas VERBATIM
    (note the paper counts the FFN as two linear maps, 4bshf, not swiglu's
    three; we keep its convention so the validation numbers line up)."""
    head_dim = d.h // d.a
    kv_dim = d.g * head_dim                    # the paper's (g*a) term
    qkv = 2 * (d.b * d.s * d.h ** 2 + 2 * d.b * d.s * d.h * kv_dim)
    attn = 4 * d.b * d.s ** 2 * d.h
    attn_out = 2 * d.b * d.s * d.h * kv_dim
    ffn = 4 * d.b * d.s * d.h * d.f
    rope = 2 * d.b * d.s * d.h
    per_layer = qkv + attn + attn_out + ffn + rope
    vocab = 4 * d.b * d.s * d.h * d.v
    return per_layer * d.L + vocab


def iteration_flops(d: LlamaDims) -> float:
    """fwd + bwd = 3x fwd (no activation checkpointing, per the report)."""
    return 3.0 * forward_flops(d)


def iteration_time(d: LlamaDims, achieved_flops_per_gpu: float,
                   n_gpus: int) -> float:
    return iteration_flops(d) / (achieved_flops_per_gpu * n_gpus)


def checkpoint_time(params: float, bytes_per_param: float = 5.93,
                    storage_tput: float = 2e12) -> float:
    """Paper App. A: 405B checkpoint over a 2 TB/s storage cluster ~ 1.2 s."""
    return params * bytes_per_param / storage_tput


# ---------------------------------------------------------------------------
# Appendix B: waste + cost
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CostParams:
    failure_rate: float = 2.0e-5     # lambda: failures per GPU-hour (Meta)
    n_gpus: int = 16384              # N
    duration_h: float = 54 * 24      # D: training duration (hours)
    iter_time_s: float = 4.58        # t
    ckpt_stall_s: float = 1.2        # omega
    gpu_price: float = 11.06         # $/GPU/h (H100 SXM5, GCP)
    cpu_price: float = 1.28          # $/CPU-node/h (32 cores / 128 GB)
    cpu_nodes: int = 128             # C (Checkmate shadow cluster)


def wasted_gpu_hours_sota(f: float, p: CostParams) -> float:
    """Eq. 2: ND( 0.5*lambda*N*f*t + omega/(f*t) ), times in hours."""
    t = p.iter_time_s / 3600.0
    w = p.ckpt_stall_s / 3600.0
    return p.n_gpus * p.duration_h * (
        0.5 * p.failure_rate * p.n_gpus * f * t + w / (f * t))


def optimal_frequency(p: CostParams) -> float:
    """f* = sqrt(2*omega / (lambda*N*t^2)), floored at 1 (Appendix B)."""
    t = p.iter_time_s / 3600.0
    w = p.ckpt_stall_s / 3600.0
    f = math.sqrt(2.0 * w / (p.failure_rate * p.n_gpus * t * t))
    return max(f, 1.0)


def wasted_gpu_hours_sota_min(p: CostParams) -> float:
    return wasted_gpu_hours_sota(optimal_frequency(p), p)


def wasted_gpu_hours_checkmate(p: CostParams) -> float:
    """Per-iteration checkpoints: half an iteration repeated per failure."""
    t = p.iter_time_s / 3600.0
    return 0.5 * p.failure_rate * p.n_gpus ** 2 * p.duration_h * t


def cost_sota_min(p: CostParams) -> float:
    return p.gpu_price * wasted_gpu_hours_sota_min(p)


def cost_checkmate(p: CostParams) -> float:
    """Eq. 4: wasted GPU cost + shadow-cluster CPU cost."""
    return (p.gpu_price * wasted_gpu_hours_checkmate(p)
            + p.cpu_price * p.duration_h * p.cpu_nodes)


def cpu_node_hours(p: CostParams) -> float:
    return p.duration_h * p.cpu_nodes


def gpu_hours_saved_per_day(p: CostParams) -> float:
    """Figure 11 y-axis: expected GPU-hours saved per day vs tuned SOTA."""
    per_run = wasted_gpu_hours_sota_min(p) - wasted_gpu_hours_checkmate(p)
    return per_run / (p.duration_h / 24.0)


def savings_usd(p: CostParams) -> float:
    return cost_sota_min(p) - cost_checkmate(p)


def sweep_frequencies(p: CostParams, freqs) -> list[tuple[float, float]]:
    """(f, wasted GPU-hours) pairs — Figure 1 curve."""
    return [(f, wasted_gpu_hours_sota(f, p)) for f in freqs]


def sweep_overhead(p: CostParams, overheads_s, cluster_sizes
                   ) -> dict[int, list[tuple[float, float]]]:
    """Figure 11: {cluster size: [(omega, saved GPU-h/day), ...]}."""
    out = {}
    for n in cluster_sizes:
        rows = []
        for w in overheads_s:
            q = CostParams(failure_rate=p.failure_rate, n_gpus=n,
                           duration_h=p.duration_h, iter_time_s=p.iter_time_s,
                           ckpt_stall_s=w, gpu_price=p.gpu_price,
                           cpu_price=p.cpu_price, cpu_nodes=p.cpu_nodes)
            rows.append((w, gpu_hours_saved_per_day(q)))
        out[n] = rows
    return out


# ---------------------------------------------------------------------------
# Shadow-plane budgets (§4.1.1, §6.3): how many shadow nodes does a given
# capture layout need, and does it fit at all?
# ---------------------------------------------------------------------------

#: Resident optimizer-state streams per gradient element on a shadow node:
#: params (wire dtype) + mu + nu (float32 each) — §4.2's functional replay.
MOMENT_BYTES_PER_ELEM = 8          # mu + nu, float32 each


@dataclass(frozen=True)
class ShadowBudget:
    """Per-node resources of one shadow box.

    Defaults model the paper's dual-NIC CPU host (2x100 GbE, §4.1.1) with a
    1.5 TB DRAM configuration; ``ram_headroom`` reserves a fraction for the
    OS, rx buffers, and consolidation scratch.
    """
    ram_bytes_per_node: float = 1.5e12
    nic_gbps_per_node: float = 200.0
    max_nodes: int = 64
    ram_headroom: float = 0.9
    # durability tier behind the node (repro_torch.durability): sustained
    # local write bandwidth and capacity for the flushed base + delta
    # chain. Defaults model a 4-NVMe RAID-0 scratch volume.
    disk_gbps_per_node: float = 96.0
    disk_bytes_per_node: float = 30e12

    @property
    def usable_ram(self) -> float:
        return self.ram_bytes_per_node * self.ram_headroom


class ShadowPlanError(ValueError):
    """No shadow fleet within budget can absorb this layout (the planner's
    loud refusal — the message says which resource failed and what to change)."""


@dataclass(frozen=True)
class ShadowPlan:
    """Feasible sharding of a capture layout across shadow nodes."""
    n_nodes: int               # minimum feasible node count
    ram_bound: int             # nodes needed by aggregate resident state
    nic_bound: int             # nodes needed by per-iteration wire bytes
    grad_bytes: int            # wire bytes per iteration (all buckets)
    state_bytes: int           # resident p+mu+nu bytes across the fleet
    bytes_per_node_max: int    # largest per-node resident state (RSS proxy)
    gbps_per_node_max: float   # hottest node's ingest rate
    n_buckets: int
    # durability flush budget terms (1/0.0 when no flush policy given):
    flush_bound: int = 1       # nodes needed by sustained flush bandwidth
    disk_bound: int = 1        # nodes needed by retained base+delta bytes
    flush_gbps_per_node_max: float = 0.0   # hottest node's flush rate


def _bucket_state_bytes(bucket) -> int:
    from repro_torch.core.buckets import ITEMSIZE, bucket_dtype
    return bucket.size * (ITEMSIZE[bucket_dtype(bucket)]
                          + MOMENT_BYTES_PER_ELEM)


#: int8 payload + per-slot f32 scales vs the raw p+mu+nu streams — the
#: planning-time shrink factor for a compressed delta flush.
FLUSH_COMPRESS_FACTOR = 0.25


def plan_shadow_nodes(layout, *, iter_time_s: float = 4.58,
                      budget: ShadowBudget = ShadowBudget(),
                      flush_every_steps: int | None = None,
                      flush_compress: bool = False,
                      retain_epochs: int = 8) -> ShadowPlan:
    """Minimum shadow-node count for ``layout`` under ``budget``.

    Two aggregate bounds (RAM: resident p+mu+nu must fit the fleet; NIC:
    each node must ingest its buckets' wire bytes within one iteration)
    plus a granularity pass: buckets are indivisible, so the byte-balanced
    assignment at the candidate count must actually fit per node. Raises
    :class:`ShadowPlanError` with an actionable message when nothing
    within ``budget.max_nodes`` fits.

    ``flush_every_steps`` adds the durability budget
    (repro_torch.durability):
    each node must sustain flushing its partition's worst-case dirty
    state (every bucket, p+mu+nu; times :data:`FLUSH_COMPRESS_FACTOR`
    when ``flush_compress``) to its tier once per flush epoch within the
    epoch's wall time, and retain one base plus ``retain_epochs`` deltas
    on ``budget.disk_bytes_per_node``. ``None`` (default) skips the
    durability terms entirely — plans are unchanged from a fleet with no
    tiers attached.
    """
    from repro_torch.core.multicast import assign_buckets, node_partitions

    if not layout.buckets:
        raise ShadowPlanError("empty layout: nothing to shadow")
    grad_bytes = layout.total_bytes
    state_bytes = sum(_bucket_state_bytes(b) for b in layout.buckets)
    nic_bytes_per_iter = budget.nic_gbps_per_node * 1e9 / 8.0 * iter_time_s

    # Indivisible-bucket feasibility: the largest bucket must fit ONE node.
    big = max(layout.buckets, key=_bucket_state_bytes)
    if _bucket_state_bytes(big) > budget.usable_ram:
        raise ShadowPlanError(
            f"bucket {big.bucket_id} ({len(big.slots)} leaves) needs "
            f"{_bucket_state_bytes(big) / 1e9:.1f} GB resident state but a "
            f"node offers {budget.usable_ram / 1e9:.1f} GB usable; buckets "
            "are indivisible — rebucket the capture with a smaller "
            "cap_bytes or raise ShadowBudget.ram_bytes_per_node")
    if big.nbytes > nic_bytes_per_iter:
        raise ShadowPlanError(
            f"bucket {big.bucket_id} carries {big.nbytes / 1e9:.1f} GB per "
            f"iteration but a node's NIC absorbs "
            f"{nic_bytes_per_iter / 1e9:.1f} GB in {iter_time_s:.2f} s; "
            "rebucket with a smaller cap_bytes or raise "
            "ShadowBudget.nic_gbps_per_node")

    ram_bound = max(1, math.ceil(state_bytes / budget.usable_ram))
    nic_bound = max(1, math.ceil(grad_bytes / nic_bytes_per_iter))

    # durability terms: worst-case flush bytes per epoch + retained chain
    flush_factor = FLUSH_COMPRESS_FACTOR if flush_compress else 1.0
    flush_bound = disk_bound = 1
    flush_bytes_per_epoch = retained_bytes = 0.0
    disk_bytes_per_epoch = 0.0
    if flush_every_steps is not None:
        if flush_every_steps < 1:
            raise ShadowPlanError(
                f"flush_every_steps must be >= 1, got {flush_every_steps}")
        epoch_s = flush_every_steps * iter_time_s
        disk_bytes_per_epoch = budget.disk_gbps_per_node * 1e9 / 8.0 * epoch_s
        flush_bytes_per_epoch = state_bytes * flush_factor
        retained_bytes = state_bytes * (1.0 + retain_epochs * flush_factor)
        big_flush = _bucket_state_bytes(big) * flush_factor
        if big_flush > disk_bytes_per_epoch:
            raise ShadowPlanError(
                f"bucket {big.bucket_id} flushes {big_flush / 1e9:.1f} GB "
                f"per epoch but a node's tier absorbs "
                f"{disk_bytes_per_epoch / 1e9:.1f} GB in {epoch_s:.2f} s; "
                "rebucket with a smaller cap_bytes, raise "
                "ShadowBudget.disk_gbps_per_node, or flush less often "
                "(FlushPolicy.every_steps)")
        if _bucket_state_bytes(big) * (1.0 + retain_epochs * flush_factor) \
                > budget.disk_bytes_per_node:
            raise ShadowPlanError(
                f"bucket {big.bucket_id}'s retained base+delta chain "
                f"exceeds ShadowBudget.disk_bytes_per_node="
                f"{budget.disk_bytes_per_node / 1e12:.1f} TB; lower "
                "retain_epochs or add tier capacity")
        flush_bound = max(1, math.ceil(
            flush_bytes_per_epoch / disk_bytes_per_epoch))
        disk_bound = max(1, math.ceil(
            retained_bytes / budget.disk_bytes_per_node))

    by_id = {b.bucket_id: b for b in layout.buckets}
    n = max(ram_bound, nic_bound, flush_bound, disk_bound)
    while n <= budget.max_nodes:
        owners = assign_buckets(layout, n)
        parts = node_partitions(layout, owners, n)
        per_state = [sum(_bucket_state_bytes(by_id[i]) for i in bs)
                     for bs in parts]
        per_wire = [sum(by_id[i].nbytes for i in bs) for bs in parts]
        fits = (max(per_state) <= budget.usable_ram
                and max(per_wire) <= nic_bytes_per_iter)
        flush_gbps_max = 0.0
        if fits and flush_every_steps is not None:
            per_flush = [s * flush_factor for s in per_state]
            per_retained = [s * (1.0 + retain_epochs * flush_factor)
                            for s in per_state]
            fits = (max(per_flush) <= disk_bytes_per_epoch
                    and max(per_retained) <= budget.disk_bytes_per_node)
            flush_gbps_max = (max(per_flush) * 8.0
                              / (flush_every_steps * iter_time_s) / 1e9)
        if fits:
            return ShadowPlan(
                n_nodes=n, ram_bound=ram_bound, nic_bound=nic_bound,
                grad_bytes=grad_bytes, state_bytes=state_bytes,
                bytes_per_node_max=max(per_state),
                gbps_per_node_max=max(per_wire) * 8.0 / iter_time_s / 1e9,
                n_buckets=len(layout.buckets),
                flush_bound=flush_bound, disk_bound=disk_bound,
                flush_gbps_per_node_max=flush_gbps_max)
        n += 1
    raise ShadowPlanError(
        f"layout ({grad_bytes / 1e9:.1f} GB wire, {state_bytes / 1e9:.1f} GB "
        f"resident) is infeasible within ShadowBudget.max_nodes="
        f"{budget.max_nodes} (RAM bound {ram_bound}, NIC bound {nic_bound}, "
        f"flush bound {flush_bound}, disk bound {disk_bound}); raise "
        "max_nodes, add RAM/NIC/disk per node, or lengthen iter_time_s")


# ---------------------------------------------------------------------------
# Elastic replanning: when N train ranks die with no hot spare, pick the
# largest feasible parallelism layout the survivors can host (Universal
# Checkpointing / Oobleck shape — the consolidated shadow checkpoint is
# layout-agnostic, so restore re-partitions onto whatever this plans).
# ---------------------------------------------------------------------------


class ElasticPlanError(ValueError):
    """No layout on the surviving ranks can host the job (the elastic
    planner's loud refusal — the message says which constraint failed and
    what to change)."""


@dataclass(frozen=True)
class ElasticMeshBudget:
    """Per-rank resources + layout constraints for elastic replanning.

    ``model_parallel`` and ``pipeline_stages`` are fixed by the lowered
    program (tensor/pipeline splits can't change without recompiling the
    whole partition strategy); only the DP width flexes. ``global_batch``
    (sequences) constrains feasible DP widths to even divisors so the
    re-split data stream preserves global batch order exactly.
    ``allow_fsdp`` lets the planner flip ZeRO-3-style weight sharding on
    when a full replica no longer fits a rank's HBM.
    """
    hbm_bytes_per_rank: float = 80e9      # one H100 SXM
    model_parallel: int = 1
    pipeline_stages: int = 1
    min_dp: int = 1
    global_batch: int | None = None
    allow_fsdp: bool = True
    hbm_headroom: float = 0.9             # activations, rx buffers, compiler

    @property
    def usable_hbm(self) -> float:
        return self.hbm_bytes_per_rank * self.hbm_headroom


@dataclass(frozen=True)
class ElasticPlan:
    """Largest feasible layout on the survivors (see `plan_elastic_mesh`)."""
    dp: int                        # new data-parallel width
    model: int                     # tensor-parallel width (unchanged)
    stages: int                    # pipeline depth (unchanged)
    fsdp: bool                     # weight sharding flipped on to fit?
    survivors: tuple[int, ...]     # rank ids the new mesh is built from
    dropped: tuple[int, ...]       # surviving ranks the layout can't use
    mesh_shape: tuple[int, ...]    # physical mesh extents, axis order below
    axis_names: tuple[str, ...]    # ("data", "model") [+ "stage"]
    state_bytes_per_rank: int      # resident p+mu+nu bytes per rank

    @property
    def n_ranks(self) -> int:
        return self.dp * self.model * self.stages


def plan_elastic_mesh(survivors, budget: ElasticMeshBudget = ElasticMeshBudget(),
                      *, state_bytes: int | None = None,
                      layout=None, fsdp: bool = False) -> ElasticPlan:
    """Largest feasible layout from the surviving ranks.

    ``survivors`` is the surviving rank ids (or a bare count). The planner
    keeps the model/pipeline split fixed and walks the DP width DOWN from
    the widest the survivors allow, taking the first width that (a) divides
    ``budget.global_batch`` evenly when given — the re-split stream must
    preserve global batch order — and (b) fits each rank's HBM: a pure-DP
    replica holds the full ``state_bytes`` (p+mu+nu, computed from
    ``layout`` when given) per model shard; if that overflows and
    ``budget.allow_fsdp``, the planner flips FSDP on, sharding state across
    the DP width. ``fsdp=True`` pins the incoming layout's flag (an FSDP
    run never silently un-shards onto fewer ranks).

    Deterministic: the lowest-numbered survivors fill the mesh; leftover
    ranks are reported as ``dropped``. Raises :class:`ElasticPlanError`
    with an actionable message when nothing fits.
    """
    if isinstance(survivors, int):
        ids = tuple(range(survivors))
    else:
        ids = tuple(sorted(survivors))
    if len(set(ids)) != len(ids):
        raise ElasticPlanError(f"duplicate survivor rank ids: {ids}")
    per_replica = budget.model_parallel * budget.pipeline_stages
    if state_bytes is None and layout is not None:
        state_bytes = sum(_bucket_state_bytes(b) for b in layout.buckets)
    dp_max = len(ids) // per_replica
    if dp_max < budget.min_dp:
        raise ElasticPlanError(
            f"{len(ids)} survivor(s) cannot host even min_dp="
            f"{budget.min_dp} replicas of a {budget.model_parallel}-way "
            f"model x {budget.pipeline_stages}-stage split "
            f"({per_replica * budget.min_dp} ranks needed); the job cannot "
            "shrink further — restore onto replacement hardware instead")
    tried: list[str] = []
    for dp in range(dp_max, budget.min_dp - 1, -1):
        if budget.global_batch is not None and budget.global_batch % dp:
            tried.append(f"dp={dp}: does not divide global_batch="
                         f"{budget.global_batch}")
            continue
        for use_fsdp in ((True,) if fsdp else
                         (False, True) if budget.allow_fsdp else (False,)):
            per_rank = 0
            if state_bytes is not None:
                per_rank = math.ceil(state_bytes / budget.model_parallel
                                     / budget.pipeline_stages
                                     / (dp if use_fsdp else 1))
                if per_rank > budget.usable_hbm:
                    tried.append(
                        f"dp={dp}{' fsdp' if use_fsdp else ''}: "
                        f"{per_rank / 1e9:.1f} GB/rank > "
                        f"{budget.usable_hbm / 1e9:.1f} GB usable")
                    continue
            n = dp * per_replica
            shape: tuple[int, ...] = (dp, budget.model_parallel)
            names: tuple[str, ...] = ("data", "model")
            if budget.pipeline_stages > 1:
                shape += (budget.pipeline_stages,)
                names += ("stage",)
            return ElasticPlan(
                dp=dp, model=budget.model_parallel,
                stages=budget.pipeline_stages, fsdp=use_fsdp,
                survivors=ids[:n], dropped=ids[n:],
                mesh_shape=shape, axis_names=names,
                state_bytes_per_rank=int(per_rank))
    detail = "; ".join(tried) if tried else "no DP width in range"
    raise ElasticPlanError(
        f"no feasible layout on {len(ids)} survivor(s) "
        f"(model_parallel={budget.model_parallel}, "
        f"stages={budget.pipeline_stages}, min_dp={budget.min_dp}): "
        f"{detail}; relax min_dp, raise hbm_bytes_per_rank, or allow_fsdp")


def capture_leaf_specs(cfg) -> list[tuple[str, tuple, str]]:
    """``(name, shape, dtype)`` leaves as the DDP capture side sees them.

    The models stack per-layer (and per-expert) weights into mega-leaves,
    as the JAX package's scans do; the capture-side bucketer sees them
    UNSTACKED — one leaf per layer (per expert for MoE). Metadata only:
    nothing allocates.
    """
    from repro_torch.models.registry import param_specs

    out: list[tuple[str, tuple, str]] = []
    for name, spec in param_specs(cfg).items():
        entries = [(name, tuple(spec.shape), tuple(spec.logical))]
        while entries and entries[0][2] and \
                entries[0][2][0] in ("layers", "expert"):
            axis = entries[0][2][0]
            entries = [(f"{nm}.{axis}{i}", shape[1:], logical[1:])
                       for nm, shape, logical in entries
                       for i in range(shape[0])]
        out.extend((nm, shape, str(spec.dtype)) for nm, shape, _ in entries)
    return out


def capture_layout(cfg, cap_bytes: int | None = None):
    """Metadata-only :class:`~repro_torch.core.buckets.BucketLayout` of a
    config's capture-side leaves (default DDP 25 MB cap)."""
    from repro_torch.core.buckets import DEFAULT_BUCKET_BYTES, build_buckets
    return build_buckets(capture_leaf_specs(cfg),
                         cap_bytes=cap_bytes or DEFAULT_BUCKET_BYTES)


def shadow_plan_for_config(cfg, *, cap_bytes: int | None = None,
                           iter_time_s: float = 4.58,
                           budget: ShadowBudget = ShadowBudget()
                           ) -> ShadowPlan:
    """Budget-check one architecture config end to end (metadata only)."""
    return plan_shadow_nodes(capture_layout(cfg, cap_bytes),
                             iter_time_s=iter_time_s, budget=budget)
