"""Multi-pod dry run, the port of ``repro.launch.dryrun``: every
(architecture x shape x mesh) cell's own step traced for one rank of the
production mesh, on a host with no card.

Usage:
    python -m repro_torch.launch.dryrun                # all cells
    python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    python -m repro_torch.launch.dryrun --multi-pod    # 2x16x16
    python -m repro_torch.launch.dryrun --both-meshes --out results.json

Each cell runs in a fake world of 256 or 512 ranks
(`repro_torch.launch.mesh.fake_world`), set up for its trace, in which
this process is rank 0 (or the rank traced). A cell's step is the
port's own:
``build_train_step(rules=)`` (its ring reduce-scatter and all-gather run
their n - 1 point-to-point steps per leaf, returning at once),
``build_prefill_step`` or ``build_decode_step``, on meta stand-ins at
rank 0's local shapes (`registry.abstract_params`, `abstract_cache`,
`input_specs`, `train.step.abstract_train_state`), under
`repro_torch.launch.step_analysis.analyze_step`, the port's stand-in for
the reference's HLO walk. The record has the reference's keys and its
`Roofline` row at the H100's data-sheet peaks, with ``trace_s`` (the
seconds the traced step took) in place of ``lower_s`` and ``compile_s``:
nothing is lowered or compiled. Results are appended to ``--out`` after
every cell, so an interrupted run resumes where it stopped. There is no
``--save-hlo``: there is no HLO.

Every cell of a tensor-parallel family (`registry.TENSOR_PARALLEL`: all
seven, dense, moe, ssm, hybrid, audio, vlm and vit) traces the
tensor-parallel step under ``ShardingRules(mesh, fsdp=cfg.fsdp)``, as the
reference's dry run does: rank 0 holds its ``1/16`` of every leaf the
spec cuts over ``model`` (moe: its 16th of the experts; ssm and hybrid:
of the SSD heads), and under FSDP its ``wemb`` slices, gathered where
they are read, and computes the layers' share those leaves carry
(``"model": "tp"`` in the record); a serving cell's cache is cut as its
specs cut it over ``model`` (positions on ``kv_seq``, SSD heads, the
cross-attention's heads). Its work is not the same on every model rank
(the sequence-sharded attention gives a later rank's query rows more
causal pairs; the decode's one write, at the last position, falls in the
last model rank's cache block), so the cell is traced a second time, for
the last model rank of the first dp group (`last_model_rank`), and each
term of the record is the larger of the two ranks'. A family taken out
of `registry.TENSOR_PARALLEL` would keep each layer whole on every rank
of a ``model`` group (``"model": "replicated"``, its serving cells with
whole weights, FSDP off). Every cell's rows are cut over the dp ranks as
the reference's are. The optimizer is the default AdamW without
a clip: a clip reads the gradient norm back to the host, which a meta
tensor cannot give.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback

import repro_torch.configs as C
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, fake_world,
                                     make_production_mesh, world_size)
from repro_torch.launch.roofline import Roofline, model_flops_for
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import registry
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.step import (abstract_train_state, build_decode_step,
                                    build_prefill_step, build_train_step)


def last_model_rank(multi_pod: bool) -> int:
    """The global rank of the last ``model`` rank of the first dp group of
    the production mesh (row-major, ``model`` the last axis)."""
    shape, _ = MULTI_POD if multi_pod else SINGLE_POD
    return shape[-1] - 1


def trace_rank(cfg, shape, multi_pod: bool, rank: int = 0) -> dict:
    """`analyze_step`'s summary of ``cfg``'s step at ``shape`` for global
    rank ``rank`` of the production mesh, in a fake world of its size
    that this call sets up and takes down (none may be up); ``trace_s``
    is the seconds the trace took."""
    with fake_world(world_size(multi_pod), rank=rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.time()
        if shape.kind == "train":
            rules = ShardingRules(mesh, fsdp=cfg.fsdp)
            step = build_train_step(cfg, OptimizerConfig(), lambda s: 1e-3,
                                    rules)
            summary = analyze_step(step, abstract_train_state(cfg, rules),
                                   registry.input_specs(cfg, shape, rules))
        else:
            rules = ShardingRules(mesh, fsdp=cfg.fsdp
                                  and registry.tensor_parallel(cfg))
            params = registry.abstract_params(cfg, rules)
            inputs = registry.input_specs(cfg, shape, rules)
            if shape.kind == "prefill":
                summary = analyze_step(build_prefill_step(cfg, shape, rules),
                                       params, inputs)
            else:
                cache = registry.abstract_cache(cfg, rules,
                                                shape.global_batch,
                                                shape.seq_len)
                summary = analyze_step(build_decode_step(cfg, rules), params,
                                       cache, inputs["token"])
        summary["trace_s"] = time.time() - t0
    del summary["result"]
    return summary


def _larger(a, b):
    """Each number of two summaries the larger of the two (dicts of
    numbers key by key)."""
    if isinstance(a, dict):
        return {k: _larger(a.get(k, 0), b.get(k, 0))
                for k in a.keys() | b.keys()}
    return max(a, b)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches=None) -> dict:
    """Trace one cell's step for rank 0 of the production mesh and, for a
    tensor-parallel family's cell, for the last model rank of the first
    dp group too (the sequence-sharded attention gives the later model
    ranks more causal pairs; the decode writes in the last rank's cache
    block), each term the larger of the two; returns the result record
    (``trace_s`` the two traces' seconds summed). Each trace sets up its
    own fake world, so none may be up."""
    cfg = C.get(arch)
    if microbatches is not None:
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    tp = registry.tensor_parallel(cfg)
    summary = trace_rank(cfg, shape, multi_pod)
    trace_s = summary["trace_s"]
    if tp:
        last = trace_rank(cfg, shape, multi_pod, last_model_rank(multi_pod))
        trace_s += last["trace_s"]
        summary = _larger(summary, last)

    rf = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name,
        chips=world_size(multi_pod),
        flops_per_device=summary["flops_per_device"],
        bytes_per_device=summary["bytes_per_device"],
        collective_bytes_per_device=summary["collective_bytes_per_device"],
        model_flops=model_flops_for(cfg, shape),
        per_collective=summary["per_collective"])
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "chips": world_size(multi_pod),
            "trace_s": round(trace_s, 2),
            "model": "tp" if tp else "replicated",
            "memory": summary["memory"],
            "bytes_per_device_hbm": summary["memory"]["argument_bytes"]
            + summary["memory"]["temp_bytes"],
            **{k: v for k, v in rf.row().items()
               if k not in ("arch", "shape", "mesh", "chips")}}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else C.all_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for multi in meshes:
        mesh_name = "multi" if multi else "single"
        todo = [(a, s) for a in archs for s in shapes
                if (a, s, mesh_name) not in done]
        for arch, shape in todo:
            print(f"=== {arch} x {shape} x {mesh_name} ===", flush=True)
            try:
                rec = lower_cell(arch, shape, multi,
                                 microbatches=args.microbatches)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
            gc.collect()
            results.append(rec)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)
            if rec["status"] == "ok":
                print(f"  ok: trace={rec['trace_s']}s "
                      f"bound={rec['bound']} "
                      f"compute={rec['compute_s']*1e3:.1f}ms "
                      f"memory={rec['memory_s']*1e3:.1f}ms "
                      f"coll={rec['collective_s']*1e3:.1f}ms "
                      f"useful={rec['useful_flops_ratio']:.2f}",
                      flush=True)
            else:
                print(f"  {rec['status']}: "
                      f"{rec.get('reason', rec.get('error'))}",
                      flush=True)


if __name__ == "__main__":
    main()
