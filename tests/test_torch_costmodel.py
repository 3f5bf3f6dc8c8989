"""The port's cost model and shadow planner (``repro_torch.core.costmodel``)
against the JAX package's ``repro.core.costmodel``.

No tolerance: every function is the same arithmetic on the same inputs,
so each result must be equal — floats included — and each refusal must
raise the same error with the same message. `ShadowPlan` and
`ElasticPlan` are compared field for field over grids of layouts and
budgets, and the port's ``capture_layout(tinyllama-1.1b)`` must equal the
JAX one bucket for bucket.
"""
import dataclasses
import itertools

import pytest

import repro.configs as jconfigs
import repro.core.costmodel as jcm
from repro.core.buckets import build_buckets as j_build

import repro_torch.core.costmodel as tcm
from repro_torch import configs as tconfigs
from repro_torch.core.buckets import build_buckets as t_build

DIMS = [dict(b=2048, s=8192, L=126, h=16384, f=53248, v=128256, a=128, g=8),
        dict(b=8, s=2048, L=22, h=2048, f=5632, v=32000, a=32, g=4),
        dict(b=1, s=128, L=2, h=64, f=128, v=256, a=4, g=2)]
PARAMS = [dict(), dict(n_gpus=1024, failure_rate=1e-4),
          dict(iter_time_s=1.5, ckpt_stall_s=30.0, cpu_nodes=8),
          dict(duration_h=24.0, gpu_price=2.0, cpu_price=0.5)]


def _same(a, b):
    """Equal results; dataclasses field for field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    else:
        assert a == b


def _both(fn_name, *args, **kw):
    """Call ``fn_name`` in both packages: equal results, or the same error
    type and message."""
    try:
        want = getattr(jcm, fn_name)(*args, **kw)
    except ValueError as e:
        with pytest.raises(getattr(tcm, type(e).__name__)) as ei:
            getattr(tcm, fn_name)(*_port_args(args), **_port_kw(kw))
        assert str(ei.value) == str(e)
        return None
    got = getattr(tcm, fn_name)(*_port_args(args), **_port_kw(kw))
    _same(got, want)
    return got


def _port_value(x):
    if isinstance(x, jcm.ShadowBudget):
        return tcm.ShadowBudget(**dataclasses.asdict(x))
    if isinstance(x, jcm.ElasticMeshBudget):
        return tcm.ElasticMeshBudget(**dataclasses.asdict(x))
    if isinstance(x, jcm.CostParams):
        return tcm.CostParams(**dataclasses.asdict(x))
    if isinstance(x, jcm.LlamaDims):
        return tcm.LlamaDims(**dataclasses.asdict(x))
    if type(x).__name__ == "BucketLayout":
        return _LAYOUTS[id(x)]
    return x


def _port_args(args):
    return [_port_value(a) for a in args]


def _port_kw(kw):
    return {k: _port_value(v) for k, v in kw.items()}


_LAYOUTS = {}


def _layouts(n_leaves=8, elems=1024, cap=2, dtype="float32"):
    """The same metadata-only layout from both packages' bucketers."""
    leaves = [(f"w{i}", (elems + 64 * i,), dtype) for i in range(n_leaves)]
    j = j_build(leaves, cap_bytes=cap * elems * 4)
    t = t_build(leaves, cap_bytes=cap * elems * 4)
    _LAYOUTS[id(j)] = t
    return j, t


@pytest.mark.parametrize("d", range(len(DIMS)))
def test_flops_and_times_equal_jax(d):
    jd = jcm.LlamaDims(**DIMS[d])
    for fn in ("forward_flops", "iteration_flops"):
        _both(fn, jd)
    for flops, n in ((400e12, 16384), (1e15, 8)):
        _both("iteration_time", jd, flops, n)
    for params, bpp, tput in ((405e9, 5.93, 2e12), (1.1e9, 12.0, 1e9)):
        _both("checkpoint_time", params, bpp, tput)
    _same(tcm.LLAMA3_405B, jcm.LLAMA3_405B)


@pytest.mark.parametrize("p", range(len(PARAMS)))
def test_waste_and_cost_equal_jax(p):
    jp = jcm.CostParams(**PARAMS[p])
    for fn in ("optimal_frequency", "wasted_gpu_hours_sota_min",
               "wasted_gpu_hours_checkmate", "cost_sota_min",
               "cost_checkmate", "cpu_node_hours", "gpu_hours_saved_per_day",
               "savings_usd"):
        _both(fn, jp)
    for f in (1.0, 7.5, 300.0):
        _both("wasted_gpu_hours_sota", f, jp)
    _both("sweep_frequencies", jp, [1, 10, 100, 1000])
    _both("sweep_overhead", jp, [0.1, 1.2, 30.0], [1024, 16384])


BUDGETS = [dict(), dict(ram_bytes_per_node=2e5, nic_gbps_per_node=1e6),
           dict(nic_gbps_per_node=0.01), dict(ram_bytes_per_node=1024),
           dict(ram_bytes_per_node=2e4, max_nodes=3),
           dict(disk_gbps_per_node=1e-9), dict(disk_gbps_per_node=0.02),
           dict(disk_bytes_per_node=1e5), dict(disk_bytes_per_node=1e7)]
FLUSH = [dict(), dict(flush_every_steps=1), dict(flush_every_steps=4),
         dict(flush_every_steps=2, flush_compress=True, retain_epochs=3),
         dict(flush_every_steps=0)]


@pytest.mark.parametrize("cap", [1, 2, 4])
@pytest.mark.parametrize("b", range(len(BUDGETS)))
def test_shadow_plan_equal_jax_field_for_field(b, cap):
    """Every (budget, flush terms, iteration time) cell: the same plan, or
    the same `ShadowPlanError` message."""
    jl, _ = _layouts(cap=cap)
    budget = jcm.ShadowBudget(**BUDGETS[b])
    planned = 0
    for flush, it in itertools.product(FLUSH, (4.58, 0.05)):
        planned += _both("plan_shadow_nodes", jl, iter_time_s=it,
                         budget=budget, **flush) is not None
    if b == 0:
        assert planned == 2 * (len(FLUSH) - 1)


def test_empty_layout_is_refused_like_jax():
    jl, _ = _layouts(n_leaves=0)
    assert not jl.buckets
    assert _both("plan_shadow_nodes", jl) is None


@pytest.mark.parametrize("survivors", [8, 7, 4, 1, (0, 2, 3, 5, 6, 9)])
@pytest.mark.parametrize("budget", [
    dict(), dict(global_batch=6), dict(model_parallel=2),
    dict(model_parallel=2, pipeline_stages=2, min_dp=2),
    dict(hbm_bytes_per_rank=10e9), dict(hbm_bytes_per_rank=10e9,
                                        allow_fsdp=False),
    dict(min_dp=9)])
def test_elastic_plan_equal_jax(survivors, budget):
    jb = jcm.ElasticMeshBudget(**budget)
    for kw in (dict(), dict(state_bytes=40e9), dict(state_bytes=40e9,
                                                     fsdp=True)):
        plan = _both("plan_elastic_mesh", survivors, jb, **kw)
        if plan is not None:
            assert plan.n_ranks == plan.dp * plan.model * plan.stages
    jl, _ = _layouts()
    _both("plan_elastic_mesh", survivors, jb, layout=jl)


def test_duplicate_survivors_refused_like_jax():
    _both("plan_elastic_mesh", (1, 1, 2))


def test_capture_layout_and_plan_of_tinyllama_equal_jax():
    jcfg, tcfg = jconfigs.get("tinyllama-1.1b"), tconfigs.get("tinyllama-1.1b")
    assert tcm.capture_leaf_specs(tcfg) == jcm.capture_leaf_specs(jcfg)
    for cap in (None, 4 << 20):
        jl, tl = jcm.capture_layout(jcfg, cap), tcm.capture_layout(tcfg, cap)
        assert len(tl.buckets) == len(jl.buckets) > 22
        for a, b in zip(tl.buckets, jl.buckets):
            assert (a.bucket_id, a.size, a.nbytes) == \
                (b.bucket_id, b.size, b.nbytes)
            assert [dataclasses.astuple(s) for s in a.slots] == \
                [dataclasses.astuple(s) for s in b.slots]
        assert sum(tcm._bucket_state_bytes(b) for b in tl.buckets) == \
            sum(jcm._bucket_state_bytes(b) for b in jl.buckets)
    for it in (4.58, 1.6):
        _same(tcm.shadow_plan_for_config(tcfg, iter_time_s=it),
              jcm.shadow_plan_for_config(jcfg, iter_time_s=it))
    assert tcm.FLUSH_COMPRESS_FACTOR == jcm.FLUSH_COMPRESS_FACTOR
    assert tcm.MOMENT_BYTES_PER_ELEM == jcm.MOMENT_BYTES_PER_ELEM


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED + jconfigs.PAPER)
def test_capture_layout_and_plan_of_every_arch_equal_jax(arch):
    """Every architecture's capture-side layout (unstacked per layer and
    per expert) and shadow plan, metadata only, as the JAX package's."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert tcm.capture_leaf_specs(tcfg) == jcm.capture_leaf_specs(jcfg)
    jl, tl = jcm.capture_layout(jcfg), tcm.capture_layout(tcfg)
    assert len(tl.buckets) == len(jl.buckets)
    for a, b in zip(tl.buckets, jl.buckets):
        assert (a.bucket_id, a.size, a.nbytes) == \
            (b.bucket_id, b.size, b.nbytes)
        assert [dataclasses.astuple(s) for s in a.slots] == \
            [dataclasses.astuple(s) for s in b.slots]
    tplan, jplan = (tcm.shadow_plan_for_config(tcfg),
                    jcm.shadow_plan_for_config(jcfg))
    _same(tplan, jplan)
    if arch == "arctic-480b":
        assert tplan.n_nodes == 17


def test_flush_terms_size_the_fleet_and_compression_relaxes_them():
    """The durability terms as tests/test_durability.py drives them, on
    the port: a tier that barely absorbs the largest bucket per epoch
    spreads the state; compression relaxes that bound."""
    _, lo = _layouts(n_leaves=6, elems=64, cap=2)
    big = max(tcm._bucket_state_bytes(b) for b in lo.buckets)
    budget = tcm.ShadowBudget(disk_gbps_per_node=big * 1.05 * 8.0 / 1e9 /
                              4.58)
    raw = tcm.plan_shadow_nodes(lo, budget=budget, flush_every_steps=1)
    packed = tcm.plan_shadow_nodes(lo, budget=budget, flush_every_steps=1,
                                   flush_compress=True)
    assert raw.flush_bound >= 2 and raw.n_nodes >= raw.flush_bound
    assert packed.flush_bound < raw.flush_bound
    plain = tcm.plan_shadow_nodes(lo)
    assert (plain.flush_bound, plain.disk_bound,
            plain.flush_gbps_per_node_max) == (1, 1, 0.0)
