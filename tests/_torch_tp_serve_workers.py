"""Rank workers of the port's tensor-parallel serving test (spawned by
``tests/_torch_spawn.py``; no JAX here: spawn imports this module).

``tp_serve`` runs, on four gloo ranks of a (2, 2) ("data", "model") mesh,
the port's prefill and greedy decode of every case in `CASES` from the
reference's initial params and inputs (tests/test_torch_tp_serve.py's
``.npz``), then ``launch.serve.generate`` on the CLI's own prompts, and
writes what each rank saw to ``rank<r>.pt``: the logits made whole over
the mesh, the greedy tokens, this rank's cache block after prefill and
after the last step, and the local shapes of the params it served from.
"""
import argparse
import os

import numpy as np
import torch

from repro_torch import configs as TC
from repro_torch.dist.sharding import Mesh, ShardingRules, dp_axes
from repro_torch.launch import serve as tserve
from repro_torch.models import registry
from repro_torch.train.step import build_decode_step, serving_params

# tag -> (arch, overrides of .reduced(), max_seq). A 16-token prompt and 4
# decode steps write positions 0..19. 36 cuts the cache into 18-position
# blocks: the first two steps' tokens land on model rank 0 while rank 1's
# block is wholly masked, the last two on rank 1. tinyllama's 4:2 heads
# are cut on whole heads; 3 heads and 1 kv head take the sequence-sharded
# prefill (wq cut at 1.5 heads); granite's one kv head is cut inside
# (gelu2, FSDP); arctic is the moe with its dense residual (FSDP); llava's
# 8 patches and 16 tokens span both blocks of 40; 37 positions do not
# divide over 2 ranks, so the cache stays whole.
CASES = {"dense": ("tinyllama-1.1b", {}, 36),
         "seq": ("tinyllama-1.1b", {"num_heads": 3, "num_kv_heads": 1}, 36),
         "granite": ("granite-34b", {}, 36),
         "arctic": ("arctic-480b", {}, 36),
         "vlm": ("llava-next-mistral-7b", {}, 40),
         "odd": ("tinyllama-1.1b", {}, 37)}
BATCH, PROMPT, STEPS = 4, 16, 4
# the CLI's run: generate() on tinyllama's reference weights at f32
CLI = dict(batch=4, prompt_len=16, gen=4, seed=0)


def case_cfg(tag: str):
    arch, over, _ = CASES[tag]
    return TC.get(arch).reduced(compute_dtype="float32", **over)


def ref_params(ref, tag: str) -> dict:
    pre = f"{tag}/init/"
    return {k[len(pre):]: torch.from_numpy(np.array(ref[k]))
            for k in ref.files if k.startswith(pre)}


def whole_logits(logits, cfg, rules):
    """This rank's logits (its dp rows; its vocab columns where the vocab
    is cut over ``model``) made whole on every rank."""
    mesh = rules.mesh
    if registry.serving_shardings(cfg, rules)["embed"].m > 1:
        logits = torch.cat(mesh.all_gather(logits, "model"), dim=-1)
    return torch.cat(mesh.all_gather(logits, dp_axes(mesh)), dim=0)


def whole_rows(t, rules):
    return torch.cat(rules.mesh.all_gather(t, dp_axes(rules.mesh)), dim=0)


def _block(cache: dict) -> dict:
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in cache.items()}


def serve_case(ref, tag: str, rules, out: dict):
    cfg = case_cfg(tag)
    max_seq = CASES[tag][2]
    params = serving_params(cfg, ref_params(ref, tag), rules)
    out[f"{tag}/param_shapes"] = {k: tuple(p.shape)
                                  for k, p in params.items()}
    tokens = rules.shard(torch.from_numpy(ref[f"{tag}/tokens"]), "batch",
                         None)
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = rules.shard(
            torch.from_numpy(ref[f"{tag}/patch_embeds"]), "batch", None,
            None)
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


def tp_serve(rank, ref_path, out_dir):
    ref = np.load(ref_path)
    mesh = Mesh.over_ranks((2, 2), ("data", "model"), device="cpu")
    out = {"coords": dict(mesh.coords)}
    for tag in CASES:
        cfg = case_cfg(tag)
        serve_case(ref, tag, ShardingRules(mesh, fsdp=cfg.fsdp), out)

    # launch.serve.generate over the mesh, the CLI's prompts, on the
    # reference's tinyllama weights at f32
    cfg = case_cfg("dense")
    weights = ref_params(ref, "dense")
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
