"""Batched serving example: prefill + KV-cache greedy decode across
families (dense GQA, SSM constant-state, hybrid), the port of
``examples/serve_decode.py``.

    python -m repro_torch.examples.serve_decode [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.examples._cli import parser
from repro_torch.models import registry
from repro_torch.train.step import build_decode_step, serving_params

ARCHS = ("tinyllama-1.1b", "mamba2-2.7b", "zamba2-1.2b", "glm4-9b")
BATCH, PROMPT, GEN = 4, 32, 12


def run(arch: str, device, batch=BATCH, prompt=PROMPT, gen=GEN,
        cfg=None, params=None) -> dict:
    """Prefill ``batch`` random prompts of ``arch``'s reduced config and
    decode ``gen`` tokens greedily; returns the first sequence's tokens.
    ``cfg`` and ``params`` (f32 leaves on ``device``) override the config
    and the seed-0 weights."""
    cfg = cfg or configs.get(arch).reduced()
    rng = np.random.default_rng(0)
    if params is None:
        params = registry.init_params(cfg, 0, device)
    params = serving_params(cfg, params)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, prompt)),
                             dtype=torch.int64, device=device)
    cache, logits = registry.prefill(params, cfg, tokens,
                                     max_seq=prompt + gen)
    decode = build_decode_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [int(tok[0, 0])]
    t0 = time.time()
    for _ in range(gen - 1):
        tok, cache = decode(params, cache, tok)
        out.append(int(tok[0, 0]))
    dt = time.time() - t0
    print(f"{arch:22s} [{cfg.family:6s}] decoded {out[:6]}... "
          f"{batch * (gen - 1) / dt:7.1f} tok/s")
    return {"arch": arch, "family": cfg.family, "tokens": out,
            "cache_length": cache["length"], "batch": batch,
            "prompt": prompt}


def main(argv=None) -> dict:
    device = resolve(parser(__doc__).parse_args(argv).device)
    return {arch: run(arch, device) for arch in ARCHS}


if __name__ == "__main__":
    main()
