"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
training step, and the operations and bytes each measured kernel needs.

Peaks copied from ``repro_torch/launch/roofline.py`` (NVIDIA's H100 SXM
data sheet, dense rates, 700 W). The step's model FLOPs follow that
module's 6ND with attention's two products added; recomputation is not
counted, since it is work the model does not need.
"""
from __future__ import annotations

PEAK_BF16 = 989e12          # FLOP/s per card, bf16 tensor cores, dense
HBM_BW = 3.35e12            # B/s per card, HBM3

# bytes one AdamW element moves: p, m, v read and written, g read (f32)
ADAMW_BYTES = 4 * 7
# bytes one gradient element moves through the bucket pack: read, written
PACK_BYTES = 4 * 2


def tokens_per_row(model: dict, traffic: dict) -> int:
    """Positions a row feeds the model: its sequence, or a ViT's
    patches."""
    return model["num_patches"] if model["family"] == "vit" \
        else traffic["seq"]


def layer_matmul_params(model: dict) -> int:
    """Weights one token meets in one layer's matrix products."""
    d, f = model["d_model"], model["d_ff"]
    h, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    return 2 * d * h * hd + 2 * d * kv * hd + 2 * d * f


def attention_pairs(model: dict, s: int) -> int:
    """Query-key pairs one head of one sequence scores: all of them, or
    the lower triangle with its diagonal where the mask is causal."""
    return s * (s + 1) // 2 if model["family"] == "dense" else s * s


def step_model_flops(model: dict, traffic: dict) -> float:
    """Model FLOPs of one training step: 6 per multiplied weight and
    token (forward 2, backward 4), the output head once a row for a ViT
    (it reads the pooled row), and QK^T and PV at the mask's extent, three
    times their forward."""
    b = traffic["batch"]
    s = tokens_per_row(model, traffic)
    per_token = model["num_layers"] * layer_matmul_params(model)
    head = model["d_model"] * model["vocab_size"]
    if model["family"] == "vit":
        weights = 6.0 * (per_token * b * s + head * b)
    else:
        weights = 6.0 * (per_token + head) * b * s
    attn_fwd = (4.0 * model["num_heads"] * model["head_dim"]
                * attention_pairs(model, s) * b * model["num_layers"])
    return weights + 3.0 * attn_fwd


def flash_launch(model: dict, traffic: dict) -> tuple[float, float]:
    """(operations, bytes) of one flash forward launch: one microbatch of
    one layer at the published head dim (a kernel that zero-fills the head
    dim does more work than the model needs). Bytes: q, k, v read and o
    written in bf16, the f32 log-sum-exp written."""
    b = traffic["batch"] // traffic["microbatches"]
    s = tokens_per_row(model, traffic)
    h, hd = model["num_heads"], model["head_dim"]
    kv = model["num_kv_heads"]
    ops = 4.0 * b * h * hd * attention_pairs(model, s)
    nbytes = 2.0 * b * s * hd * (2 * h + 2 * kv) + 4.0 * b * h * s
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory term."""
    return max(ops / PEAK_BF16, nbytes / HBM_BW)
