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
        """Pure function of (seed, step) (token families)."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        b, s, cfg = self.batch, self.seq, self.cfg
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def device_batch(batch: dict, device) -> dict:
    """numpy batch -> int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device=device, dtype=torch.int64)
            for k, v in batch.items()}
