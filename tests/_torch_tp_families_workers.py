"""Rank workers of the tensor-parallel CPU tests of the ssm, hybrid, audio
and vit families (spawned by ``tests/_torch_spawn.py``; no JAX here: spawn
imports this module).

``families_train`` runs, on four gloo ranks of a (2, 2) ("data", "model")
mesh, everything tests/test_torch_tp_families_train.py holds against the
reference's GSPMD dump, and writes what each rank saw to ``rank<r>.pt``.
``families_serve`` does the same for tests/test_torch_tp_families_serve.py:
prefill and greedy decode of each serving case, then
``launch.serve.generate`` of mamba2 over the mesh.
"""
import argparse
import os

import numpy as np
import torch

from _torch_dp_workers import _captured_run, initial_state, local_state
from _torch_tp_serve_workers import _block, ref_params, whole_logits, \
    whole_rows
from _torch_tp_workers import OPT, run_cases

from repro_torch import configs as TC
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.sharding import Mesh, ShardingRules
from repro_torch.launch import serve as tserve
from repro_torch.models import registry
from repro_torch.train.step import build_decode_step, serving_params

# tag -> (arch, overrides of .reduced()): mamba2 (8 SSD heads, 4 a rank;
# the vocab of 256 cut), mamba2 with a vocab of 255 (embed and unembed
# whole) under FSDP (each layer's wemb slices gathered in the layer loop),
# zamba2 (two calls of the shared block, its 4:2 heads cut on whole
# heads), whisper (encoder, decoder and cross-attention over 2 of its 4
# heads) and vit-h-14 as a ViT (no RoPE; its 256 classes cut)
CASES = {"mamba2": ("mamba2-2.7b", {}),
         "mamba2_fsdp": ("mamba2-2.7b", {"vocab_size": 255, "fsdp": True}),
         "zamba2": ("zamba2-1.2b", {}),
         "whisper": ("whisper-medium", {}),
         "vit": ("vit-h-14", {"family": "vit"})}
# the leaves each case cuts over model (the rest whole on every model rank)
SSM_CUT = {"wz", "wx", "wdt", "conv_x", "A_log", "D", "dt_bias",
           "gate_norm", "w_out"}
DENSE_CUT = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
MODEL_CUT = {
    "mamba2": SSM_CUT | {"embed", "unembed"},
    "mamba2_fsdp": SSM_CUT,
    "zamba2": SSM_CUT | {"embed", "unembed"}
    | {"shared_" + k for k in DENSE_CUT},
    "whisper": {"embed", "unembed", "xwq", "xwk", "xwv", "xwo"}
    | {p + k for p in ("enc_", "dec_") for k in DENSE_CUT},
    "vit": DENSE_CUT | {"head"}}
CAPTURE_STEPS = 2


def case_cfg(tag: str, cases=CASES):
    arch, over = cases[tag]
    return TC.get(arch).reduced(compute_dtype="float32", microbatches=2,
                                **over)


def families_train(rank, ref_path, out_dir):
    ref = np.load(ref_path)
    out = {}
    m22 = Mesh.over_ranks((2, 2), ("data", "model"), device="cpu")
    run_cases(ref, CASES, m22, out)
    # the capture of each case into a shadow on rank 0: trainer = shadow
    # bitwise, each step captured once
    for tag in CASES:
        cfg = case_cfg(tag)
        rules = ShardingRules(m22, fsdp=cfg.fsdp)
        start = initial_state(ref, tag, cfg)
        _captured_run(cfg, rules, local_state(cfg, rules, start),
                      CAPTURE_STEPS, out, f"capture/{tag}", opt=OPT)
    # a leaf gathered whole along its last dim: its gradient is this
    # model rank's columns of the gradient summed over the model group
    tp = TP.ModelParallel(m22, ())
    x = torch.arange(24.0).reshape(6, 4).requires_grad_(True)
    g = torch.arange(48.0).reshape(6, 8) * (tp.rank + 1)
    (gx,) = torch.autograd.grad(TP.gather_from_model(x, -1, tp), x, g)
    out["gather/grad"] = gx
    out["gather/want"] = (3 * torch.arange(48.0).reshape(6, 8))[
        :, 4 * tp.rank:4 * tp.rank + 4]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# -- serving -------------------------------------------------------------------

# tag -> (arch, overrides of .reduced(), max_seq). A 16-token prompt and 4
# decode steps write positions 0..19; 36 cuts zamba2's and whisper's
# self-attention caches into 18-position blocks (the first two steps'
# tokens land on model rank 0, the last two on rank 1). mamba2's cache has
# no positions; its state's 8 heads and x conv's 128 columns are cut in
# half. whisper encodes its 32 frames.
SERVE_CASES = {"mamba2": ("mamba2-2.7b", {}, 36),
               "zamba2": ("zamba2-1.2b", {}, 36),
               "whisper": ("whisper-medium", {}, 36)}
BATCH, PROMPT, STEPS = 4, 16, 4
# the CLI's run: generate() on mamba2's reference weights at f32
CLI = dict(batch=4, prompt_len=16, gen=4, seed=0)


def serve_cfg(tag: str):
    arch, over, _ = SERVE_CASES[tag]
    return TC.get(arch).reduced(compute_dtype="float32", **over)


def serve_case(ref, tag: str, rules, out: dict):
    cfg = serve_cfg(tag)
    max_seq = SERVE_CASES[tag][2]
    params = serving_params(cfg, ref_params(ref, tag), rules)
    out[f"{tag}/param_shapes"] = {k: tuple(p.shape)
                                  for k, p in params.items()}
    tokens = rules.shard(torch.from_numpy(ref[f"{tag}/tokens"]), "batch",
                         None)
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = rules.shard(torch.from_numpy(ref[f"{tag}/frames"]),
                                      "batch", None, None)
    cache, logits = registry.prefill(params, cfg, tokens, max_seq,
                                     rules=rules, **extra)
    out[f"{tag}/prefill/logits"] = whole_logits(logits, cfg, rules)
    out[f"{tag}/prefill/cache"] = _block(cache)
    tok = first = registry.greedy_token(cfg, logits, rules)
    toks = [whole_rows(tok, rules)]
    saved = _block(cache)
    for i in range(STEPS):
        logits, cache = registry.decode_step(params, cfg, cache, tok, rules)
        out[f"{tag}/decode/{i}/logits"] = whole_logits(logits, cfg, rules)
        tok = registry.greedy_token(cfg, logits, rules)
        toks.append(whole_rows(tok, rules))
    out[f"{tag}/tokens"] = torch.cat(toks, dim=1)
    out[f"{tag}/decode/cache"] = _block(cache)
    # the built decode step from the same prefill gives the same tokens
    step, tok = build_decode_step(cfg, rules), first
    again = [tok]
    for _ in range(STEPS):
        tok, saved = step(params, saved, tok)
        again.append(tok)
    out[f"{tag}/step_tokens"] = whole_rows(torch.cat(again, dim=1), rules)


def families_serve(rank, ref_path, out_dir):
    ref = np.load(ref_path)
    mesh = Mesh.over_ranks((2, 2), ("data", "model"), device="cpu")
    out = {"coords": dict(mesh.coords)}
    for tag in SERVE_CASES:
        serve_case(ref, tag, ShardingRules(mesh, fsdp=serve_cfg(tag).fsdp),
                   out)
    # launch.serve.generate over the mesh, the CLI's prompts, on the
    # reference's mamba2 weights at f32
    cfg = serve_cfg("mamba2")
    weights = ref_params(ref, "mamba2")
    real = registry.init_params
    registry.init_params = lambda c, seed, device: dict(weights)
    try:
        got, _, _ = tserve.generate(
            cfg, argparse.Namespace(**CLI), torch.device("cpu"),
            ShardingRules(mesh))
    finally:
        registry.init_params = real
    out["cli/tokens"] = torch.from_numpy(np.asarray(got))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
