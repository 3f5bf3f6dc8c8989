"""Where the mma.sync flash kernel's time goes, and what its design choices
bought, on one card.

    python3 tools/flash_mma_variants.py      # one H100, about a minute

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu`` side
by side, each one text substitution of the source, with the flags of
``repro_torch.kernels.build`` into ``build/flash_variants/``; holds each
against the plain version (``ref.flash_attention_ref``) and times it with
CUDA events beside SDPA, at the f32 main shape (2, 2048, 32, 4, 64) and at
(1, 2048, 32, 8, 128), causal. Then times ``mma.sync`` m16n8k8 TF32 alone
(independent products, no loads) for the rate the kernel's products can
reach on this card. Prints one line per shape and a JSON line.

Variants:
  kernel          the source as it is
  cvt_rna         the TF32 split by cvt.rna.tf32.f32 instead of integer adds
  one_m_tile      one m16 tile of query rows a warp (BQ 64) and 64-row kv
                  tiles up to D = 64
  rescale_branch  O rescaled under a branch, only when a row's max moves
  stages3         three K/V stages in the ring
  no_split        (wrong numbers) no split work, three products: the split
  one_product     (wrong numbers) the split work, one product of three:
                  the other two products
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402

OUT = os.path.join(ROOT, "build", "flash_variants")
SHAPES = ((2, 2048, 32, 4, 64), (1, 2048, 32, 8, 128))

SPLIT = """    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;"""
RESCALE = """      const float corr = mnew == m[r] ? 1.f : ex2(m[r] - mnew);
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[mt][n][h2] *= corr;
        acc[mt][n][h2 + 1] *= corr;
      }
      m[r] = mnew;"""
SMALL_TERMS = """#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], alo, bhi[i][0], bhi[i][1]);
  if constexpr (SPLIT_B) {
#pragma unroll
    for (int i = 0; i < N; ++i) mma(c[i], ahi, blo[i][0], blo[i][1]);
  }"""
VARIANTS = {
    "kernel": [],
    "cvt_rna": [(SPLIT, """    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));""")],
    "one_m_tile": [("return D <= 64 ? 2 : 1;", "return 1;"),
                   ("return D >= 256 ? 16 : 32;",
                    "return D >= 256 ? 16 : D >= 128 ? 32 : 64;")],
    "rescale_branch": [(RESCALE, """      if (mnew != m[r]) {
        const float corr = ex2(m[r] - mnew);
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[mt][n][h2] *= corr;
          acc[mt][n][h2 + 1] *= corr;
        }
        m[r] = mnew;
      }""")],
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "no_split": [(SPLIT, """    hi = __float_as_uint(x);
    lo = hi;""")],
    # keep the split values live so the compiler keeps their work
    "one_product": [(SMALL_TERMS, """#pragma unroll
  for (int i = 0; i < N; ++i)
    c[i][0] += __uint_as_float(alo[0] ^ bhi[i][0] ^ blo[i][1]);""")],
}

RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Independent m16n8k8 TF32 products, 8 accumulators a warp, no loads.
__global__ void mma_rate(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u, 0x3f800000u};
  const uint32_t b0 = 0x3f800000u, b1 = 0x3e000000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(float* out, int blocks, int threads, int iters,
                               void* stream) {
  mma_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"flash_mma_variants: the source no longer has "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_all() -> tuple[dict, ctypes.CDLL]:
    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(build.CSRC, "flash_attention.cu")).read()
    exe = build.nvcc()
    jobs = {}
    sources = {name: variant_source(src, subs)
               for name, subs in VARIANTS.items()}
    sources["mma_rate"] = RATE_SRC
    for name, text in sources.items():
        cu, so = os.path.join(OUT, name + ".cu"), os.path.join(OUT, name + ".so")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = (so, subprocess.Popen(
            [exe, *build.ARCH, *build.COMMON, "-Xptxas", "-v", "-shared", cu,
             "-o", so], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_mma_variants: nvcc failed for {name}:\n"
                             f"{log}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        if spills:
            print(f"{name}: spills: {spills}", flush=True)
        libs[name] = ctypes.CDLL(so)
    rate = libs.pop("mma_rate")
    for lib in libs.values():
        lib.repro_flash_fwd.argtypes = build.SIGNATURES["repro_flash_fwd"]
        lib.repro_flash_fwd.restype = ctypes.c_int
    rate.mma_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    rate.mma_rate_launch.restype = ctypes.c_int
    return libs, rate


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(lib, q, k, v):
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device)
    build.check(lib.repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d, 1, 0,
        1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream),
        "flash variant")
    return o, lse


def mma_rate_tflops(rate, warps_per_block: int, blocks_per_sm: int) -> float:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * blocks_per_sm, 32 * warps_per_block, 4096
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = time_ms(lambda: build.check(rate.mma_rate_launch(
        out.data_ptr(), blocks, threads, iters, stream), "mma_rate"), 5, 1)
    flops = blocks * warps_per_block * iters * 8 * 2.0 * 16 * 8 * 8
    return flops / (ms * 1e-3) / 1e12


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flash_mma_variants: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs, rate = build_all()
    gen = torch.Generator(device="cuda").manual_seed(3)
    result = {"card": smi, "shapes": {}}
    for b, s, h, kv, d in SHAPES:
        def rnd(shape, sc):
            return torch.randn(shape, generator=gen, device="cuda") * sc
        q, k, v = rnd((b, s, h, d), 0.3), rnd((b, s, kv, d), 0.3), \
            rnd((b, s, kv, d), 1.0)
        want, _ = ref.flash_attention_ref(q, k, v, True)
        qt = q.transpose(1, 2)
        kt, vt = (ref.expand_kv(x, h).transpose(1, 2) for x in (k, v))
        row = {"sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))}
        for name, lib in libs.items():
            o, _ = run(lib, q, k, v)
            torch.cuda.synchronize()
            row[name] = {"ms": min(time_ms(lambda: run(lib, q, k, v))
                                   for _ in range(2)),
                         "max_abs_err": (o - want).abs().max().item()}
        key = f"{b}x{s}x{h}x{kv}x{d}"
        result["shapes"][key] = row
        print(f"{key} f32: sdpa {row['sdpa_ms']:.4f} ms | " + " | ".join(
            f"{n} {r['ms']:.4f} ms (err {r['max_abs_err']:.2e})"
            for n, r in row.items() if n != "sdpa_ms"), flush=True)
        del q, k, v, want, qt, kt, vt
        torch.cuda.empty_cache()
    result["mma_sync_tf32_tflops"] = {
        f"{w} warps x {bl} blocks an SM": mma_rate_tflops(rate, w, bl)
        for w, bl in ((4, 2), (4, 4), (8, 4))}
    print(f"mma.sync m16n8k8 TF32 alone: {result['mma_sync_tf32_tflops']} "
          f"TFLOP/s", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
