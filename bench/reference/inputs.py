"""What the benchmark hands both sides: the weights and the batches, made
from the run's seed.

Plain PyTorch and NumPy. The program under test receives the same tensors
(the weights) or draws the same rows itself (the batches), so the
reference and the program start from identical inputs without sharing
any code of the program.

Weights are drawn on the device by one ``torch.Generator`` per chunk of
leaves (a few large ``randn`` calls, each leaf a slice of one), so a
chunk can be drawn again on its own: the harness regenerates the initial
weights chunk by chunk to measure how far training moved them, without
keeping a second copy of the state.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# leaves are drawn in chunks of at least this many elements (1 GiB of f32),
# a leaf larger than that in a chunk of its own
CHUNK_ELEMENTS = 1 << 28
# elements of each leaf's first gradient read out for the comparison
PROBE = 1 << 20
LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_up",
              "w_down")


def param_layout(model: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every leaf of ``model`` (a configuration
    file's ``model`` group), sorted by name. Per-layer weights are stacked
    ``(num_layers, ...)``; ``init`` is ``normal`` (std 0.02), ``fan_in``
    (std 1/sqrt(rows)) or ``ones``."""
    if model["mlp"] != "gelu2":
        raise ValueError(f"the reference has the gelu2 MLP only, not "
                         f"{model['mlp']!r}")
    n, d, f = model["num_layers"], model["d_model"], model["d_ff"]
    h, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    out = {
        "attn_norm": ((n, d), "ones"),
        "wq": ((n, d, h * hd), "fan_in"),
        "wk": ((n, d, kv * hd), "fan_in"),
        "wv": ((n, d, kv * hd), "fan_in"),
        "wo": ((n, h * hd, d), "fan_in"),
        "mlp_norm": ((n, d), "ones"),
        "w_up": ((n, d, f), "fan_in"),
        "w_down": ((n, f, d), "fan_in"),
        "final_norm": ((d,), "ones"),
    }
    if model["family"] == "dense":
        out["embed"] = ((model["vocab_size"], d), "normal")
        if not model.get("tie_embeddings", False):
            out["unembed"] = ((d, model["vocab_size"]), "fan_in")
    elif model["family"] == "vit":
        out["head"] = ((d, model["vocab_size"]), "fan_in")
    else:
        raise ValueError(f"no reference for family {model['family']!r}")
    return [(k, out[k][0], out[k][1]) for k in sorted(out)]


def _std(shape: tuple, init: str) -> float:
    if init == "normal":
        return 0.02
    rows = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(rows)


def _chunks(layout: list) -> list[list]:
    """The random leaves grouped in layout order into chunks of at least
    CHUNK_ELEMENTS elements (the last may be smaller)."""
    chunks, cur, size = [], [], 0
    for leaf in layout:
        if leaf[2] == "ones":
            continue
        cur.append(leaf)
        size += math.prod(leaf[1])
        if size >= CHUNK_ELEMENTS:
            chunks.append(cur)
            cur, size = [], 0
    if cur:
        chunks.append(cur)
    return chunks


def chunk_seed(seed: int, index: int) -> int:
    """The generator seed of chunk ``index`` of a run seeded ``seed``."""
    return (seed * 1_000_003 + index) % (1 << 63)


def iter_params(layout: list, seed: int, device):
    """Yield ``(name, f32 tensor)`` for every leaf of ``layout``, chunk by
    chunk: one ``randn`` a chunk, each leaf a scaled copy of its slice."""
    for name, shape, init in layout:
        if init == "ones":
            yield name, torch.ones(shape, dtype=torch.float32, device=device)
    for i, chunk in enumerate(_chunks(layout)):
        gen = torch.Generator(device=device).manual_seed(chunk_seed(seed, i))
        total = sum(math.prod(s) for _, s, _ in chunk)
        flat = torch.randn(total, generator=gen, dtype=torch.float32,
                           device=device)
        off = 0
        for name, shape, init in chunk:
            n = math.prod(shape)
            yield name, flat[off:off + n].view(shape) * _std(shape, init)
            off += n
        del flat


def make_params(layout: list, seed: int, device) -> dict:
    """Every leaf of ``layout`` as an f32 tensor on ``device``, in layout
    (sorted) order."""
    made = dict(iter_params(layout, seed, device))
    return {name: made[name] for name, _, _ in layout}


def probe_indices(layout: list, seed: int, size: int = PROBE) -> dict:
    """For each leaf, up to ``size`` flat indices drawn from the seed: the
    elements of the first gradient that the program and the reference
    both read out, to compare the gradients element by element without
    copying whole trees."""
    rng = np.random.default_rng([seed, 1])
    out = {}
    for name, shape, _ in layout:
        n = math.prod(shape)
        idx = (np.arange(n) if n <= size
               else rng.integers(0, n, size=size))
        out[name] = torch.from_numpy(idx.astype(np.int64))
    return out


def batch_at(model: dict, batch: int, seq: int, seed: int,
             step: int) -> dict:
    """The rows of step ``step`` (0-based), a pure function of (seed,
    step). Frozen copy of ``repro_torch.data.synthetic.SyntheticStream
    .batch_at`` for the dense and vit families: the program draws these
    rows itself, and the reference draws them again here."""
    rng = np.random.default_rng((seed << 32) ^ step)
    if model["family"] == "vit":
        return {
            "patch_embeds": rng.standard_normal(
                (batch, model["num_patches"], model["d_model"])).astype(
                    np.float32) * 0.02,
            "labels": rng.integers(0, model["vocab_size"],
                                   (batch, 1)).astype(np.int32),
        }
    toks = rng.integers(0, model["vocab_size"], (batch, seq + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
