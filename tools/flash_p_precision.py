"""How the precision of P in the P·V product moves the flash forward's error.

    PYTHONPATH=src python3 tools/flash_p_precision.py      # CPU, ~1 min

Emulates the tensor-core flash kernel's arithmetic on the CPU in float32:
bf16 q, k, v; scores in f32; an online softmax over 128-row kv tiles with
exp2 and a running max; l summed from the f32 P; P rounded to the given
format before P·V, accumulated in f32; o rounded to bf16. Each variant is
held against the plain version (``ref.flash_attention_ref``, f32 P) with
``chip_smoke.py``'s limit for bf16 ``o``, ``1e-2*|ref| + 1e-4``, and prints
the worst ratio of error to limit over all rows and over rows past s/2, at
the inputs of ``chip_smoke.check_flash``: q, k x 0.3, v ~ N(0, 1),
(b, s, h, kv, d) = (1, 2048, 8, 1, 64), causal.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from repro_torch.kernels.ref import causal_mask, expand_kv, flash_attention_ref

BK = 128


def _round_tf32(x):
    """Round to nearest, ties away, at TF32's 10 stored mantissa bits."""
    bits = x.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def split_bf16(p):
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


ROUND = {
    "bf16": lambda p: p.to(torch.bfloat16).float(),
    "fp16": lambda p: p.to(torch.float16).float(),
    "tf32": _round_tf32,
    "bf16 x2 (P_hi + P_lo)": split_bf16,
    "f32": lambda p: p,
}


def emulate(q, k, v, rnd):
    """The kernel's online softmax over kv tiles, P rounded by ``rnd``."""
    h, d = q.shape[2], q.shape[3]
    sq, skv = q.shape[1], k.shape[1]
    scale_log2 = 1.0 / math.sqrt(d) * math.log2(math.e)
    qf = q.float().transpose(1, 2)                          # (b, h, s, d)
    kf = expand_kv(k, h).float().transpose(1, 2)
    vf = expand_kv(v, h).float().transpose(1, 2)
    mask = causal_mask(sq, skv, q.device)
    m = torch.full(qf.shape[:3], -math.inf)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, skv, BK):
        s = qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)
        s = s.masked_fill(~mask[:, k0:k0 + BK], -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + rnd(p) @ vf[:, :, k0:k0 + BK]
        m = m_new
    return (acc / l[..., None]).transpose(1, 2).to(torch.bfloat16)


def main():
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 1, 2048, 8, 1, 64

    def rnd(shape, sc):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * sc).to(torch.bfloat16)
    q, k, v = rnd((b, s, h, d), 0.3), rnd((b, s, kv, d), 0.3), rnd((b, s, kv, d), 1.0)
    ref, _ = flash_attention_ref(q, k, v, True)
    ref = ref.float()
    limit = 1e-2 * ref.abs() + 1e-4
    out = {}
    for name, fn in ROUND.items():
        ratio = (emulate(q, k, v, fn).float() - ref).abs() / limit
        out[name] = {"all_rows": ratio.max().item(),
                     "rows_past_half": ratio[:, s // 2:].max().item()}
        print(f"P as {name:22s} worst ratio to the limit: all rows "
              f"{out[name]['all_rows']:.3f}, rows past s/2 "
              f"{out[name]['rows_past_half']:.3f}", flush=True)
    print(json.dumps({"shape": [b, s, h, kv, d], "causal": True,
                      "ratio_to_limit": out}))


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
