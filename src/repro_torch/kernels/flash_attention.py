"""Flash-attention forward wrapper: a CUDA kernel for tensors on the card,
the plain version (`ref.flash_attention_ref`) for tensors on the CPU.

Two kernels, chosen by :func:`route`: the wgmma kernel
(``csrc/flash_attention_wgmma.cu``) for bf16 at a head_dim that is a multiple
of 8 up to 128, and the mma.sync kernel (``csrc/flash_attention.cu``, 3xTF32)
for f32 and for bf16 at any other head_dim up to 256. Each counts its own
launches.

On meta tensors (the dry run) it returns ``o`` and ``lse`` as empty meta
tensors of the kernel's shapes and records the kernel's work
(`flash_work`) into the step analysis listening, if any.

Returns ``(o, lse)``: the recompute backward of the model's attention
(`repro_torch.models.layers.FlashAttention`) needs the row log-sum-exp.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

launches_wgmma = build.LaunchCounter()
launches_mma = build.LaunchCounter()
MAX_HEAD_DIM = 256


def route(dtype, d: int) -> str:
    """The kernel that takes (dtype, head_dim) on the card: "wgmma" for bf16
    at a d that is a multiple of 8 from 8 to 128 (the TMA unit needs 16-byte
    row strides), "mma" for f32 and for bf16 at any other d up to 256."""
    if dtype not in (torch.float32, torch.bfloat16) or not (
            1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: no kernel for {dtype} at head_dim "
                         f"{d} (float32 or bfloat16, 1 <= head_dim <= "
                         f"{MAX_HEAD_DIM})")
    if dtype == torch.bfloat16 and d % 8 == 0 and d <= 128:
        return "wgmma"
    return "mma"


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (b, s, h, d)")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {k.shape[2]} kv heads do not "
                         f"divide {h} heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


def causal_pairs(sq: int, skv: int, q_offset: int = 0) -> int:
    """The (q, k) pairs a top-left causal mask keeps when row i keeps the
    keys up to ``q_offset + i``: min(q_offset + i + 1, skv) a row."""
    full = max(0, min(sq, skv - q_offset))     # rows below the last key
    pairs = full * (2 * q_offset + full + 1) // 2
    return pairs + (sq - full) * skv


def flash_work(q, k, causal: bool, q_offset: int = 0
               ) -> tuple[float, float]:
    """(FLOPs, bytes) of one forward: the two products, 4 b h d per (q, k)
    pair the mask keeps (sq skv, or `causal_pairs` where causal); q, k, v
    read once, o and the f32 lse written once. The bound the kernel rows
    of ``PERF.md`` use."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    pairs = causal_pairs(sq, skv, q_offset) if causal else sq * skv
    flops = 4.0 * b * h * d * pairs
    nbytes = (q.element_size() * (2 * b * sq * h * d + 2 * b * skv * hkv * d)
              + 4 * b * h * sq)
    return flops, nbytes


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0):
    """q: (b, sq, h, d); k, v: (b, skv, kv, d) with kv dividing h (kv == h
    is pre-expanded kv). Causal masking is top-left (qpos >= kpos), the
    queries at absolute positions ``q_offset + i`` (a rank's rows of a
    sequence-sharded attention); 0 is the plain top-left mask."""
    _check(q, k, v)
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, q_offset)
    if q.device.type == "meta":
        route(q.dtype, q.shape[3])
        build.record_work("flash_attention",
                          *flash_work(q, k, causal, q_offset))
        return (torch.empty_like(q), torch.empty(
            (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
            device=q.device))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kernel = route(q.dtype, d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, skv, h, hkv, d, int(causal), q_offset)
    stream = build.stream_ptr(q.device)
    if kernel == "wgmma":
        # the TMA unit reads q, k and v from 16-byte aligned addresses
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} is not 16-byte "
                                 f"aligned")
        code = lib.repro_flash_fwd_wgmma(*args, 1.0 / math.sqrt(d), stream)
        build.check(code, "flash_attention (wgmma)")
        launches_wgmma.add()
    else:
        code = lib.repro_flash_fwd(*args, int(q.dtype == torch.bfloat16),
                                   1.0 / math.sqrt(d), stream)
        build.check(code, "flash_attention (mma)")
        launches_mma.add()
    return o, lse
