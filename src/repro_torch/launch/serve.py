"""Batched serving CLI, the port of ``repro.launch.serve``: prefill and
greedy decode with a KV (or SSM) cache.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --batch 8 \
        --prompt-len 2048 --gen 64                  # full width, on the card
    python -m repro_torch.launch.serve --arch glm4-9b --reduced \
        --batch 4 --prompt-len 32 --gen 16 --device cpu

Prints the reference's JSON report (same keys). Prompt tokens, frames
(audio) and patch embeddings (vlm) are drawn from
``np.random.default_rng(seed)`` in the reference's order and scale; the
weights from the port's own ``init_params(seed)``. The flags are the
reference's, ``--mesh {smoke,single,multi}`` included, and ``--device
{cuda,cpu}`` is new (default ``cuda``; it raises without a GPU).

``--mesh smoke`` (the default) serves every row in one process.
``single`` and ``multi`` serve over the production mesh
(`launch.mesh.make_production_mesh`: 256 or 512 ranks, one process per
rank, as ``torchrun`` starts them) under ``ShardingRules(mesh,
fsdp=cfg.fsdp)``: each dp rank prefills and decodes its own contiguous
rows of the batch, the reference's row order (the batch must divide over
the dp ranks), and the ranks of its model group share those rows. Every
family that serves (dense, moe, ssm, hybrid, audio, vlm) serves over
``model``: each rank holds its slices of the weights (FSDP's gathered a
layer at a time) and its cut of the cache (`repro_torch.models
.registry`: a block of the positions, its SSD heads, its cross-attention
heads). Every rank gathers the
tokens over its dp ranks; global rank 0 prints the report, and its times
are rank 0's. In a world of another size (one process) they raise the
mesh's ``ValueError``. A vlm's cache holds the patches too:
``num_patches + prompt_len + gen`` positions, where the reference sizes it
``prompt_len + gen`` and so cannot serve a vlm. The clock is read after a
device synchronisation each time.
"""
from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="smoke",
                    choices=["smoke", "single", "multi"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def max_seq_for(cfg, prompt_len: int, gen: int) -> int:
    """Cache positions: the prompt and the generated tokens, and before
    them a vlm's patches."""
    return prompt_len + gen + (cfg.num_patches if cfg.family == "vlm" else 0)


def run(args: argparse.Namespace) -> dict:
    """Serve as ``args`` say; the report (None on a rank other than global
    rank 0)."""
    import torch.distributed as dist

    import repro_torch.configs as C
    from repro_torch.device import resolve
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.mesh import join_world, make_production_mesh

    device = resolve(args.device)
    cfg = C.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rules = None
    if args.mesh != "smoke":
        join_world(device)
        rules = ShardingRules(make_production_mesh(
            multi_pod=args.mesh == "multi", device=device), fsdp=cfg.fsdp)
    out, t_prefill, t_decode = generate(cfg, args, device, rules)
    if rules is not None and dist.get_rank() != 0:
        return None
    return {
        "arch": cfg.name, "batch": args.batch,
        "prompt_len": args.prompt_len, "generated": args.gen,
        "prefill_s": round(t_prefill, 3),
        "decode_s": round(t_decode, 3),
        "decode_tok_per_s": round(args.batch * (args.gen - 1)
                                  / max(t_decode, 1e-9), 1),
        "sample_tokens": out[0][:8].tolist(),
    }


def generate(cfg, args: argparse.Namespace, device, rules=None) -> tuple:
    """Prefill and greedy decode of ``args.batch`` prompts: (the tokens
    (batch, gen), prefill seconds, decode seconds). With ``rules`` over
    more than one dp rank this rank serves its rows (``rules.shard`` of
    every input over "batch") and the tokens are gathered over the dp
    ranks, row order kept, on every rank; over ``model`` it serves from
    its slices of the weights (`train.step.serving_params`)."""
    import numpy as np
    import torch

    from repro_torch.dist.sharding import dp_axes
    from repro_torch.models import registry
    from repro_torch.train.step import build_decode_step, serving_params

    n = 1 if rules is None else rules.axis_size("batch")
    if args.batch % n:
        raise ValueError(f"batch {args.batch} does not divide over {n} dp "
                         f"ranks")

    def rows(x):
        return x if n == 1 else rules.shard(x, "batch",
                                            *([None] * (x.dim() - 1)))

    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    rng = np.random.default_rng(args.seed)
    params = serving_params(cfg, registry.init_params(cfg, args.seed, device),
                            rules)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=device)
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = torch.as_tensor(
            rng.standard_normal((args.batch, cfg.encoder_seq, cfg.d_model)),
            device=device).to(torch.bfloat16) * 0.02
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((args.batch, cfg.num_patches, cfg.d_model)),
            device=device).to(torch.bfloat16) * 0.02

    tokens = rows(tokens).contiguous()
    extra = {k: rows(v).contiguous() for k, v in extra.items()}
    t0 = clock()
    cache, logits = registry.prefill(
        params, cfg, tokens, max_seq_for(cfg, args.prompt_len, args.gen),
        rules=rules, **extra)
    t_prefill = clock() - t0

    decode = build_decode_step(cfg, rules)
    tok = registry.greedy_token(cfg, logits, rules)
    generated = [tok]
    t0 = clock()
    for _ in range(args.gen - 1):
        tok, cache = decode(params, cache, tok)
        generated.append(tok)
    t_decode = clock() - t0

    out = torch.cat(generated, dim=1)
    if n > 1:
        out = torch.cat(rules.mesh.all_gather(out, dp_axes(rules.mesh)))
    return out.cpu().numpy(), t_prefill, t_decode


def main(argv=None):
    report = run(parse_args(argv))
    if report is not None:
        print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
