"""Deterministic synthetic data, the port of ``repro.data.synthetic``.

Batches are a pure function of (seed, step), so a restarted run replays the
identical stream from any step; ``batch_at`` is the JAX package's, so both
packages train on the same tokens. Every rank draws the global batch and
``device_batch`` keeps the rows that rank works on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import dp_axes


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


def local_rows(bsz: int, rules=None, microbatches: int = 1) -> np.ndarray:
    """The global batch rows a rank takes, in the reference's layout.

    The reference shards the global batch over the dp axes and its step
    reshapes it to (microbatches, B / microbatches): microbatch ``i`` is
    rows ``[i B/mb, (i+1) B/mb)``, and dp rank ``r`` works on the r-th
    contiguous n-th of that microbatch (not of the whole batch). So the
    rank's rows are, microbatch by microbatch, its n-th of each; the
    step splits them into ``microbatches`` again. Raises ``ValueError``
    where B / mb does not divide by n (the reference then falls back to
    a replicated batch)."""
    n = 1 if rules is None else rules.axis_size("batch")
    if n == 1:
        return np.arange(bsz)
    if bsz % microbatches or (bsz // microbatches) % n:
        raise ValueError(f"batch {bsz} in {microbatches} microbatches does "
                         f"not split over {n} dp ranks")
    per = bsz // microbatches
    r = rules.mesh.coordinate(dp_axes(rules.mesh))
    return np.concatenate([np.arange(i * per + r * (per // n),
                                     i * per + (r + 1) * (per // n))
                           for i in range(microbatches)])


def device_batch(batch: dict, device, rules=None,
                 microbatches: int = 1) -> dict:
    """numpy batch -> tensors on ``device``: integer arrays as int64 (the
    index type), float arrays as float32. With ``rules`` over more than
    one dp rank, only this rank's rows (`local_rows`)."""
    out = {}
    for k, v in batch.items():
        rows = local_rows(v.shape[0], rules, microbatches)
        if len(rows) != v.shape[0]:
            v = v[rows]
        dtype = (torch.float32 if np.issubdtype(v.dtype, np.floating)
                 else torch.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
            device=device, dtype=dtype)
    return out
