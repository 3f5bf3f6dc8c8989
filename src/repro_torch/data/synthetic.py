"""Deterministic synthetic data, the port of ``repro.data.synthetic``.

Batches are a pure function of (seed, step), so a restarted run replays the
identical stream from any step; ``batch_at`` is the JAX package's, so both
packages train on the same tokens.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass
class SyntheticStream:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step). Token families draw ``seq + 1``
        tokens; audio adds frames, vlm patch embeddings (before the text),
        and vit draws patch embeddings and one label per image."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        b, s, cfg = self.batch, self.seq, self.cfg
        if cfg.family == "vit":
            return {
                "patch_embeds": rng.standard_normal(
                    (b, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02,
                "labels": rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
            }
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02
        return out


def device_batch(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``: integer arrays as int64 (the
    index type), float arrays as float32."""
    out = {}
    for k, v in batch.items():
        dtype = (torch.float32 if np.issubdtype(v.dtype, np.floating)
                 else torch.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
            device=device, dtype=dtype)
    return out
