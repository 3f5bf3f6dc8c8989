"""Kernel microbenchmarks: fused AdamW, flash attention and the bucket pack
beside their plain PyTorch versions, the port of ``benchmarks/kernels.py``.

On the card (the default) each Hopper kernel runs at the main path's
shapes (tinyllama-1.1b at full width): AdamW over the largest bucket of
the main path's layout, the flash forward at one microbatch of the main
run, (2, 2048, 32 heads, 4 KV heads, 64) bf16 causal, and the pack over
all of the layout's buckets. ``max_err`` is the kernel's largest
difference from its plain version on the same inputs. With
``device="cpu"`` the wrappers run the plain versions, at the JAX module's
sizes. Each call is timed by `common.timeit`: ``WARMUP`` calls, then the
median of ``REPS``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import cli_device, csv_row, timeit
from repro_torch.device import resolve
from repro_torch.kernels import ops, ref

WARMUP, REPS = 1, 3
MAIN_ARCH = "tinyllama-1.1b"
FLASH_SHAPE = (2, 2048, 32, 4, 64)       # (b, s, h, kv, d): one microbatch


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _adamw_row(p, g, m, v, device) -> tuple:
    s = ref.adamw_scalars(1, 1e-3)
    want = ref.adamw_ref(p, g, m, v, s)
    got = [t.clone() for t in (p, g, m, v)]
    ops.fused_adamw_(*got, s)
    err = max(_err(a, b) for a, b in zip((got[0], got[2], got[3]), want))
    work = [t.clone() for t in (p, g, m, v)]
    t_ref = timeit(lambda: ref.adamw_ref(p, g, m, v, s), reps=REPS,
                   warmup=WARMUP, device=device)
    t_k = timeit(lambda: ops.fused_adamw_(*work, s), reps=REPS,
                 warmup=WARMUP, device=device)
    return csv_row("kernel.fused_adamw", t_k * 1e6,
                   f"ref_us={t_ref * 1e6:.0f} n={p.numel()} "
                   f"max_err={err:.1e}")


def _flash_row(q, k, v, device) -> tuple:
    from repro_torch.kernels.flash_attention import route
    name = (f"flash_attention_{route(q.dtype, q.shape[-1])}"
            if q.is_cuda else "plain")
    o, lse = ops.flash_attention(q, k, v, True)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, True)
    err = _err(o, o_ref)
    t_ref = timeit(lambda: ref.flash_attention_ref(q, k, v, True),
                   reps=REPS, warmup=WARMUP, device=device)
    t_k = timeit(lambda: ops.flash_attention(q, k, v, True), reps=REPS,
                 warmup=WARMUP, device=device)
    return csv_row("kernel.flash_attention", t_k * 1e6,
                   f"ref_us={t_ref * 1e6:.0f} max_err={err:.1e} "
                   f"shape={tuple(q.shape[:3]) + tuple(k.shape[2:])} "
                   f"dtype={str(q.dtype).removeprefix('torch.')} "
                   f"kernel={name}")


def _pack_row(buckets, device) -> tuple:
    """``buckets``: [(leaves, offsets, out)]: every bucket packed once a
    call."""
    def pack(fn):
        return [fn(ls, offs, out) for ls, offs, out in buckets]
    want = pack(lambda ls, offs, out: ref.bucket_pack_ref(
        ls, offs, torch.empty_like(out)))
    got = pack(ops.pack_bucket)
    err = max(_err(a, b) for a, b in zip(got, want))
    t_ref = timeit(lambda: pack(ref.bucket_pack_ref), reps=REPS,
                   warmup=WARMUP, device=device)
    t_k = timeit(lambda: pack(ops.pack_bucket), reps=REPS, warmup=WARMUP,
                 device=device)
    nbytes = sum(out.numel() * out.element_size() for _, _, out in buckets)
    return csv_row("kernel.packed_copy", t_k * 1e6,
                   f"bytes={nbytes} buckets={len(buckets)} "
                   f"ref_us={t_ref * 1e6:.0f} max_err={err:.1e}")


def main_path_buckets(device, gen) -> list:
    """The main path's layout with random gradient leaves on ``device``:
    [(leaves, offsets, out)] per bucket."""
    from repro_torch import configs
    from repro_torch.core.buckets import build_buckets
    from repro_torch.models import registry
    specs = registry.param_specs(configs.get(MAIN_ARCH))
    layout = build_buckets([(k, tuple(sp.shape), "float32")
                            for k, sp in sorted(specs.items())])
    grads = {k: torch.randn(sp.shape, generator=gen, device=device) * 1e-3
             for k, sp in specs.items()}
    return [([grads[sl.name].reshape(-1) for sl in b.slots],
             [sl.offset for sl in b.slots],
             torch.empty(b.size, device=device)) for b in layout.buckets]


def run(device=None) -> list[tuple]:
    device = resolve(device)
    if device.type != "cuda":
        return _run_plain()
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    buckets = main_path_buckets(device, gen)
    _, _, largest = max(buckets, key=lambda b: b[2].numel())
    n = largest.numel()
    p, g, m = (torch.randn(n, generator=gen, device=device) * s
               for s in (0.02, 1e-3, 1e-4))
    v = (torch.randn(n, generator=gen, device=device) * 1e-3).square()
    rows.append(_adamw_row(p, g, m, v, device))
    del p, g, m, v
    b, s, h, kv, d = FLASH_SHAPE
    q = (torch.randn((b, s, h, d), generator=gen, device=device) * 0.3
         ).to(torch.bfloat16)
    k = (torch.randn((b, s, kv, d), generator=gen, device=device) * 0.3
         ).to(torch.bfloat16)
    vv = torch.randn((b, s, kv, d), generator=gen, device=device
                     ).to(torch.bfloat16)
    rows.append(_flash_row(q, k, vv, device))
    del q, k, vv
    rows.append(_pack_row(buckets, device))
    return rows


def _run_plain() -> list[tuple]:
    """The JAX module's sizes on the CPU (the wrappers' plain versions)."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)

    def t(shape, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)) * scale
    n = 128 * 512
    rows = [_adamw_row(t(n), t(n), torch.zeros(n), torch.zeros(n), cpu)]
    b, s, h, d = 1, 256, 4, 64
    rows.append(_flash_row(t((b, s, h, d), 0.3), t((b, s, h, d), 0.3),
                           t((b, s, h, d)), cpu))
    x = t(1 << 20)
    rows.append(_pack_row([([x], [0], torch.empty_like(x))], cpu))
    return rows


if __name__ == "__main__":
    run(device=cli_device())
