"""Fused AdamW wrapper: the CUDA kernel for tensors on the card, the plain
version (`ref.adamw_ref`) for tensors on the CPU.

The update is in place: p, m and v are overwritten, which is what lets the
shadow keep one copy of its state on the card (the JAX package donates the
buffers to a jit instead). On meta tensors (the dry run) nothing changes
in place; the bytes the kernel would move are recorded into the step
analysis listening, if any.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import AdamWScalars, adamw_ref

launches = build.LaunchCounter()


def _check(p, g, m, v):
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_adamw: p must be float32 or bfloat16, "
                        f"got {p.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adamw: {name} must be float32, "
                            f"got {t.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"fused_adamw: {name} shape {tuple(t.shape)} "
                             f"!= p shape {tuple(p.shape)}")
        if t.device != p.device:
            raise ValueError(f"fused_adamw: {name} on {t.device}, "
                             f"p on {p.device}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw: {name} is not contiguous")


def fused_adamw_(p, g, m, v, s: AdamWScalars, scale: float = 1.0):
    """AdamW in place on (p, m, v) with gradient ``g * scale``."""
    _check(p, g, m, v)
    if p.device.type == "cpu":
        pn, mn, vn = adamw_ref(p, g, m, v, s, scale)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)
        return p, m, v
    if p.device.type == "meta":
        # p read and written, g read, m and v (f32) read and written
        build.record_work("fused_adamw", 0.0,
                          p.numel() * (2 * p.element_size() + 4 + 16))
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw: unsupported device {p.device}")
    n = p.numel()
    if n == 0:
        return p, m, v
    lib = build.load()
    fn = lib.repro_adamw_f32 if p.dtype == torch.float32 else \
        lib.repro_adamw_bf16
    code = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n,
              scale, s.b1, s.omb1, s.b2, s.omb2, s.bc1, s.bc2, s.lr, s.eps,
              s.wd, build.stream_ptr(p.device))
    build.check(code, "fused_adamw")
    launches.add()
    return p, m, v
