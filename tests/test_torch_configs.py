"""The port's configs, param specs, counts, shapes, bucket layouts and
synthetic batches against the JAX package's, for all 15 architectures.

No tolerance: configs, specs and counts are the same metadata and must be
equal field for field; the batches are the same numpy draws and must be
byte-identical. Nothing is allocated at full width.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as C
import repro.core.buckets as jb
import repro.core.costmodel as jcm
from repro.data.synthetic import SyntheticStream as JStream
from repro.models import registry as jreg

from repro_torch import configs as TC
import repro_torch.core.buckets as tb
import repro_torch.core.costmodel as tcm
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.models import registry as treg

ARCHS = C.ASSIGNED + C.PAPER


def _pair(arch, family=None):
    j, t = C.get(arch), TC.get(arch)
    if family:
        j, t = (dataclasses.replace(c, family=family) for c in (j, t))
    return j, t


def test_registry_lists_equal_jax():
    assert TC.ASSIGNED == C.ASSIGNED and TC.PAPER == C.PAPER
    assert TC.all_archs() == C.all_archs()
    with pytest.raises(KeyError, match="unknown architecture"):
        TC.get("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal_field_for_field(arch):
    j, t = _pair(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    over = dict(compute_dtype="float32", microbatches=2)
    assert dataclasses.asdict(t.reduced(**over)) == \
        dataclasses.asdict(j.reduced(**over))
    for prop in ("d_inner", "ssm_heads", "attention_free", "sub_quadratic"):
        assert getattr(t, prop) == getattr(j, prop), prop


def _specs_equal(jcfg, tcfg):
    js, ts = jreg.param_specs(jcfg), treg.param_specs(tcfg)
    assert list(ts) == list(js)
    for k in js:
        assert (ts[k].shape, ts[k].logical, ts[k].init, ts[k].dtype) == \
            (tuple(js[k].shape), tuple(js[k].logical), js[k].init,
             js[k].dtype), k


@pytest.mark.parametrize("arch", ARCHS + ["vit-h-14:vit"])
def test_param_specs_and_counts_equal_jax(arch):
    name, _, family = arch.partition(":")
    j, t = _pair(name, family or None)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        _specs_equal(jc, tc)
        for active in (False, True):
            assert treg.param_count(tc, active_only=active) == \
                jreg.param_count(jc, active_only=active)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_moe_counts_are_the_published_ones():
    dbrx = TC.get("dbrx-132b")
    assert dbrx.param_count() == 131_596_523_520
    assert dbrx.active_param_count() == 36_469_708_800


def test_shapes_and_run_configs_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()}
    for arch in ARCHS:
        for shape in C.SHAPES:
            assert TC.shape_applicable(TC.get(arch), TC.SHAPES[shape]) == \
                C.shape_applicable(C.get(arch), C.SHAPES[shape])
            for over in ({}, dict(microbatches=4, fsdp=True, zero1=False)):
                jc, js = C.RunConfig(arch, shape, **over).resolve()
                tc, ts = TC.RunConfig(arch, shape, **over).resolve()
                assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
                assert dataclasses.asdict(ts) == dataclasses.asdict(js)


def _fields(layout):
    return [(b.bucket_id, b.size, b.nbytes,
             [dataclasses.astuple(s) for s in b.slots])
            for b in layout.buckets]


@pytest.mark.parametrize("arch", ["granite-34b", "dbrx-132b", "mamba2-2.7b",
                                  "zamba2-1.2b", "whisper-medium",
                                  "llava-next-mistral-7b", "vit-h-14:vit"])
def test_bucket_layout_of_each_family_equal_jax(arch):
    """The trainer's layout (sorted leaves, as init_params orders them),
    reduced and at full width, and the capture side's unstacked layout."""
    name, _, family = arch.partition(":")
    j, t = _pair(name, family or None)
    for jc, tc in ((j.reduced(), t.reduced()), (j, t)):
        js, ts = jreg.param_specs(jc), treg.param_specs(tc)
        for cap in (None, 1 << 20):
            kw = {"cap_bytes": cap} if cap else {}
            jl = jb.build_buckets([(k, js[k].shape, js[k].dtype)
                                   for k in sorted(js)], **kw)
            tl = tb.build_buckets([(k, ts[k].shape, ts[k].dtype)
                                   for k in sorted(ts)], **kw)
            assert _fields(tl) == _fields(jl)
    for cap in (None, 4 << 20):
        assert _fields(tcm.capture_layout(t.reduced(), cap)) == \
            _fields(jcm.capture_layout(j.reduced(), cap))


@pytest.mark.parametrize("family,arch", [("vit", "vit-h-14"),
                                         ("audio", "whisper-medium"),
                                         ("vlm", "llava-next-mistral-7b"),
                                         ("moe", "arctic-480b")])
def test_batches_byte_identical_and_floats_stay_float(family, arch):
    j, t = _pair(arch, family)
    j, t = j.reduced(), t.reduced()
    for step in (0, 3):
        jb_ = JStream(j, 4, 16, seed=2).batch_at(step)
        tb_ = SyntheticStream(t, 4, 16, seed=2).batch_at(step)
        assert list(tb_) == list(jb_)
        for k in jb_:
            assert tb_[k].dtype == jb_[k].dtype
            assert tb_[k].tobytes() == jb_[k].tobytes(), k
    dev = device_batch(tb_, "cpu")
    for k, v in tb_.items():
        if np.issubdtype(v.dtype, np.floating):
            assert dev[k].dtype == torch.float32
            assert torch.equal(dev[k], torch.from_numpy(v))
        else:
            assert dev[k].dtype == torch.int64
            assert torch.equal(dev[k], torch.from_numpy(v.astype(np.int64)))
    want = {"vit": {"patch_embeds", "labels"},
            "audio": {"tokens", "labels", "frames"},
            "vlm": {"tokens", "labels", "patch_embeds"},
            "moe": {"tokens", "labels"}}[family]
    assert set(tb_) == want
