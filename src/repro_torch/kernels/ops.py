"""Public entry points to the port's kernels.

Each wrapper runs its CUDA kernel for tensors on the card and its plain
PyTorch version (`repro_torch.kernels.ref`) for tensors on the CPU; there is
no fallback from one to the other. ``launch_counts`` reads how often each
kernel was launched, which is how a run shows it went through them.
"""
from __future__ import annotations

from repro_torch.kernels import bucket_pack as _bp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adamw as _fw

fused_adamw_ = _fw.fused_adamw_
flash_attention = _fa.flash_attention
flash_attention_bwd = _fa.flash_attention_bwd
pack_bucket = _bp.pack

COUNTERS = {"fused_adamw": _fw.launches,
            "flash_attention_wgmma": _fa.launches_wgmma,
            "flash_attention_mma": _fa.launches_mma,
            "flash_attention_bwd": _fa.launches_bwd,
            "bucket_pack": _bp.launches}


def launch_counts() -> dict[str, int]:
    return {name: c.value for name, c in COUNTERS.items()}


def reset_launch_counts():
    for c in COUNTERS.values():
        c.reset()
