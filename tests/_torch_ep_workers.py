"""Rank workers of the port's expert-parallel CPU test (spawned by
``tests/_torch_spawn.py``; no JAX here: spawn imports this module).

``ep_train`` runs, on four gloo ranks, everything
tests/test_torch_ep_train.py holds against the reference's dump on a
(2, 2) ("data", "model") mesh and writes what each rank saw to
``rank<r>.pt``: the four MoE cases, then a captured and a looped run of
arctic (experts over model, FSDP) and its checkpoint restored onto
(4, 1) and (1, 4).
"""
import os

import numpy as np
import torch

from _torch_dp_workers import (_captured_run, _looped_run, initial_state,
                               local_state)
from _torch_tp_workers import OPT, case_cfg, resume_on_other_meshes, \
    run_cases

from repro_torch.dist.sharding import Mesh, ShardingRules

# tag -> (arch, overrides of .reduced()): arctic (4 experts top-2, two a
# model rank, the dense residual, FSDP); arctic at capacity factor 0.5, so
# that slots drop in every group; dbrx (no residual); arctic with 3
# experts, which do not split over 2 model ranks (whole experts, the rest
# of the block tensor-parallel)
CASES = {"arctic": ("arctic-480b", {}),
         "drop": ("arctic-480b", {"capacity_factor": 0.5}),
         "dbrx": ("dbrx-132b", {}),
         "e3": ("arctic-480b", {"num_experts": 3})}


def ep_train(rank, ref_path, out_dir):
    ref = np.load(ref_path)
    out = {}
    m22 = Mesh.over_ranks((2, 2), ("data", "model"), device="cpu")
    run_cases(ref, CASES, m22, out)

    # inside the port, on arctic: the capture, the loop and the restores
    cfg = case_cfg("arctic", CASES)
    r22 = ShardingRules(m22, fsdp=cfg.fsdp)
    start = initial_state(ref, "arctic", cfg)
    shadow = _captured_run(cfg, r22, local_state(cfg, r22, start), 2, out,
                           "capture/ep", keep_shadow=True, opt=OPT)
    _looped_run(cfg, r22, out, "loop/ep", opt=OPT)
    resume_on_other_meshes(cfg, r22, shadow, out, "capture/ep")
    if shadow is not None:
        shadow.shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
