// Flash-attention backward for bf16 on Hopper's tensor cores: dq, dk and dv
// of softmax(q k^T / sqrt(d)) v from q, k, v, o, the forward's row
// log-sum-exp (lse) and do, at any head_dim d that is a multiple of 8 up to
// 128 (the wgmma forward's inputs, flash_attention_wgmma.cu).
//
// Replaces: the recompute-from-lse backward of src/repro/models/layers.py
// (_flash_bwd, the custom VJP of flash_attention_jnp), which XLA lowers
// to plain products on the TPU: no Pallas kernel of the reference computes
// it. The port computed it in plain PyTorch (kernels/ref.py::
// flash_attention_bwd_ref), which builds nine f32 (b, h, sq, skv) tensors a
// call. Here no (sq, skv) tensor leaves the chip; the only scratch is delta.
//
// Bound on an H100 SXM: operations. At gpt2-1.5b's shape (b=4, s=1024,
// h=25, d=64, causal) one call needs five products over the s(s+1)/2 causal
// pairs (recompute S, dV, dP, dK, dQ: 33.6 GFLOP, 0.034 ms at 989 TFLOP/s)
// against ~106 MB of q/k/v/o/do/dq/dk/dv/lse/delta traffic (0.032 ms at
// 3.35 TB/s). This design recomputes S and dP in both passes, so it issues
// seven products (47 GFLOP, 0.048 ms). FA2's backward (Dao, 2023,
// Algorithm 2) in three kernels:
//
// * delta = rowsum(do * o) in f32, (b, h, sq): 8 or 16 lanes a row.
// * dK/dV pass. One block per (b, kv head, 64 keys). It walks the q heads
//   of that kv head's group and, in each, the 64-row q tiles that can see
//   its keys (under a causal mask the tiles wholly above the diagonal are
//   never loaded; only tiles that cross it, or the ragged end of sq, are
//   masked). With keys as the wgmma's M: S^T = K Q^T and dP^T = V dO^T
//   from shared memory (both K-major), P^T = exp(S^T scale - lse) in f32,
//   dS^T = P^T (dP^T - delta) scale, then dV += bf16(P^T) dO and
//   dK += bf16(dS^T) Q with P^T and dS^T as register A operands and dO and
//   Q read MN-major from the same tiles. dK and dV stay in f32 registers
//   across the loop and are written once, in bf16.
// * dQ pass. One block per (b, q head, 64 rows), walking the key tiles up
//   to the diagonal: S = Q K^T, dP = dO V^T, dS as above, dQ += bf16(dS) K
//   with K read MN-major; written once, in bf16.
//
// No atomics: every sum has one order, so the gradients are bitwise the
// same from launch to launch. Rounding as the plain version rounds: S and
// dP accumulate in f32 from bf16 operands (bf16 products are exact in f32),
// P and dS are f32 and rounded to bf16 only as operands of the products
// that take them, and dq, dk and dv come out in bf16; GQA's dk and dv sum
// the group's heads in the f32 accumulator (the plain version rounds each
// head's share to bf16 first).
//
// Each block is one consumer warpgroup (M = 64 rows, the wgmma's) and one
// producer warp that keeps a ring of STAGES tile pairs filled with TMA
// (128-byte swizzle, mbarrier completion), reusing the forward's ring,
// barriers and descriptors (hopper.cuh). d <= 64 runs a 64-wide instance,
// two blocks an SM; larger d a 128-wide one (d = 80 zero-filled by the TMA
// unit, as the forward does), one block an SM. A warpgroup's products and
// its softmax run in turn; the SM's other block fills the gaps.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128 + 32;   // one consumer warpgroup, one producer warp
constexpr int BM = 64;               // rows of the block's own tile
constexpr int BN = 64;               // rows of each streamed tile
constexpr int STAGES = 2;            // streamed tile pairs in the ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int smem_bytes() {
  // alignment slack, the block's tile pair, the ring, lse/delta, barriers
  return 1024 + 2 * BM * D * 2 + STAGES * 2 * BN * D * 2 + 2 * 2 * BN * 4 +
         8 * (1 + 2 * STAGES);
}

// delta[b, hh, i] = sum_c do[b, i, hh, c] * o[b, i, hh, c] in f32 for each
// row of (b, sq, h, d), d % 8 == 0: L lanes a row (L = 8 for d <= 64, else
// 16), each reading 16 bytes of o and of do at a time.
template <int L>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int sq, int h,
                       int d) {
  const int64_t row = ((int64_t)blockIdx.x * 256 + threadIdx.x) / L;
  const int lane = threadIdx.x % L;
  const bool live = row < rows;
  float acc = 0.f;
  if (live) {
    const uint4* op = reinterpret_cast<const uint4*>(o + row * d);
    const uint4* dp = reinterpret_cast<const uint4*>(dout + row * d);
    for (int c = lane; c < d / 8; c += L) {
      const uint4 x = op[c], y = dp[c];
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xs[e]);
        const float2 g = __bfloat1622float2(ys[e]);
        acc = fmaf(a.x, g.x, acc);
        acc = fmaf(a.y, g.y, acc);
      }
    }
  }
#pragma unroll
  for (int w = L / 2; w > 0; w /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (live && lane == 0) {
    const int64_t bi = row / h;           // b * sq + i
    const int hh = (int)(row % h);
    const int64_t b = bi / sq, i = bi % sq;
    delta[(b * h + hh) * sq + i] = acc;
  }
}

// This thread's share of a 64-row wgmma accumulator: rows r0 and r0 + 8 of
// the warpgroup's 64, columns 8 * (i / 4) + cq + (i % 2) of element i.
struct Frag {
  int r0, cq;
  __device__ Frag() : r0(16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4),
                      cq(2 * (threadIdx.x % 4)) {}
};

// Write rows [row0, row0 + 64) of a (b, s, heads, d) bf16 tensor at head hh
// from an f32 accumulator of D columns; rows past s and columns past d are
// not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2],
                                           int64_t b, int row0, int s,
                                           int heads, int hh, int d) {
  const Frag f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + f.r0 + 8 * r;
    if (row >= s) continue;
    __nv_bfloat16* p = out + ((b * s + row) * heads + hh) * d + f.cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (8 * c >= d) continue;                // a zero-filled column
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
    }
  }
}

// dK/dV pass. Block (b * hkv + kvh, key tile). The tensor maps describe q,
// do (b, sq, h, d) and k, v (b, skv, hkv, d) as (d, heads, s, b) with
// 64-row boxes D columns wide.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int sq, int skv,
                            int h, int hkv, int d, int causal, int q_offset,
                            float scale, float scale_log2) {
  constexpr int NBOX = D / kBox;
  constexpr int OWN = BM * D * 2, TILE = BN * D * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + OWN;
  auto sq_s = [&](int s) { return base + 2 * OWN + (uint32_t)(s * 2 * TILE); };
  auto sdo_s = [&](int s) { return sq_s(s) + (uint32_t)TILE; };
  // lse * log2(e) and delta of the current and the next q tile
  float* stats = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + 2 * OWN + STAGES * 2 * TILE);
  const uint32_t bars = smem_u32(stats + 2 * 2 * BN);
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

  const int b = blockIdx.x / hkv, kvh = blockIdx.x % hkv;
  const int g = h / hkv;
  const int k0 = blockIdx.y * BM;        // the first key tiles, the longest, first
  // q tiles before qt0 hold rows that see no key of this block
  const int qt0 = causal ? max(0, k0 - q_offset) / BN : 0;
  const int n_qt = (sq + BN - 1) / BN;
  const int n_q = max(0, n_qt - qt0);    // q tiles a q head
  const int n = g * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * OWN);
      for (int x = 0; x < NBOX; ++x) {
        tma_load(sk + x * BM * 128, &tk, kv_full, x * kBox, kvh, k0, b);
        tma_load(sv + x * BM * 128, &tv, kv_full, x * kBox, kvh, k0, b);
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        const int hh = kvh * g + j / n_q, q0 = (qt0 + j % n_q) * BN;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * TILE);
        for (int x = 0; x < NBOX; ++x) {
          tma_load(sq_s(s) + x * BN * 128, &tq, full(s), x * kBox, hh, q0, b);
          tma_load(sdo_s(s) + x * BN * 128, &tdo, full(s), x * kBox, hh, q0,
                   b);
        }
      }
    }
    return;
  }

  const Frag f;
  const int t = threadIdx.x;
  const int krow[2] = {k0 + f.r0, k0 + f.r0 + 8};
  // thread t < 64 stages lse * log2(e) of column t of a q tile, the others
  // delta of column t - 64; masked columns past sq read 0
  auto stat = [&](int j) {
    const int hh = kvh * g + j / n_q;
    const int col = (qt0 + j % n_q) * BN + t % BN;
    if (col >= sq) return 0.f;
    const int64_t at = ((int64_t)b * h + hh) * sq + col;
    return t < BN ? lse[at] * kLog2e : delta[at];
  };
  if (n > 0) stats[t] = stat(0);
  bar_sync(1, 128);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    const int q0 = (qt0 + j % n_q) * BN;
    const float nxt = j + 1 < n ? stat(j + 1) : 0.f;
    const float* l2 = stats + (j % 2) * 2 * BN;
    const float* dl = l2 + BN;
    mbar_wait(full(s), (j / STAGES) & 1);

    float st[BN / 2], dpt[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns into the box
      wgmma_ss_n64(st, desc_sw128(sk + (kk / 4) * BM * 128 + off, 16),
                   desc_sw128(sq_s(s) + (kk / 4) * BN * 128 + off, 16), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(dpt, desc_sw128(sv + (kk / 4) * BM * 128 + off, 16),
                   desc_sw128(sdo_s(s) + (kk / 4) * BN * 128 + off, 16), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const bool edge = q0 + BN > sq || (causal && k0 + BM - 1 > q0 + q_offset);
    uint32_t pf[BN / 16][4], dsf[BN / 16][4];
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = (i / 2) % 2, c = 8 * (i / 4) + f.cq;
      const float2 lc = *reinterpret_cast<const float2*>(l2 + c);
      const float2 dc = *reinterpret_cast<const float2*>(dl + c);
      float p0 = ex2(fmaf(st[i], scale_log2, -lc.x));
      float p1 = ex2(fmaf(st[i + 1], scale_log2, -lc.y));
      if (edge) {
        const int q = q0 + c;
        if (q >= sq || (causal && krow[r] > q + q_offset)) p0 = 0.f;
        if (q + 1 >= sq || (causal && krow[r] > q + 1 + q_offset)) p1 = 0.f;
      }
      const float ds0 = p0 * (dpt[i] - dc.x) * scale;
      const float ds1 = p1 * (dpt[i + 1] - dc.y) * scale;
      pf[i / 8][(i % 8) / 2] = pack_bf16(__floats2bfloat162_rn(p0, p1));
      dsf[i / 8][(i % 8) / 2] = pack_bf16(__floats2bfloat162_rn(ds0, ds1));
    }
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(dva, pf[kk], desc_sw128(sdo_s(s) + kk * 16 * 128, BN * 128));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(dka, dsf[kk], desc_sw128(sq_s(s) + kk * 16 * 128, BN * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));    // this warp is done with stage s
    stats[((j + 1) % 2) * 2 * BN + t] = nxt;
    bar_sync(1, 128);
  }
  store_rows<D>(dk, dka, b, k0, skv, hkv, kvh, d);
  store_rows<D>(dv, dva, b, k0, skv, hkv, kvh, d);
}

// dQ pass. Block (b * h + hh, q tile); the longest q tiles first.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int sq, int skv,
                          int h, int hkv, int d, int causal, int q_offset,
                          float scale, float scale_log2) {
  constexpr int NBOX = D / kBox;
  constexpr int OWN = BM * D * 2, TILE = BN * D * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sqt = base, sdo = base + OWN;
  auto sk_s = [&](int s) { return base + 2 * OWN + (uint32_t)(s * 2 * TILE); };
  auto sv_s = [&](int s) { return sk_s(s) + (uint32_t)TILE; };
  const uint32_t bars = base + 2 * OWN + STAGES * 2 * TILE;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

  const int b = blockIdx.x / h, hh = blockIdx.x % h;
  const int kvh = hh / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kv_end = causal ? min(skv, min(q0 + BM, sq) + q_offset) : skv;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * OWN);
      for (int x = 0; x < NBOX; ++x) {
        tma_load(sqt + x * BM * 128, &tq, q_full, x * kBox, hh, q0, b);
        tma_load(sdo + x * BM * 128, &tdo, q_full, x * kBox, hh, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * TILE);
        for (int x = 0; x < NBOX; ++x) {
          tma_load(sk_s(s) + x * BN * 128, &tk, full(s), x * kBox, kvh,
                   j * BN, b);
          tma_load(sv_s(s) + x * BN * 128, &tv, full(s), x * kBox, kvh,
                   j * BN, b);
        }
      }
    }
    return;
  }

  const Frag f;
  const int rows[2] = {q0 + f.r0, q0 + f.r0 + 8};
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = ((int64_t)b * h + hh) * sq + rows[r];
    l2[r] = rows[r] < sq ? lse[at] * kLog2e : 0.f;
    dl[r] = rows[r] < sq ? delta[at] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BN;
    mbar_wait(full(s), (j / STAGES) & 1);
    float sc[BN / 2], dp[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(sc, desc_sw128(sqt + (kk / 4) * BM * 128 + off, 16),
                   desc_sw128(sk_s(s) + (kk / 4) * BN * 128 + off, 16), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(dp, desc_sw128(sdo + (kk / 4) * BM * 128 + off, 16),
                   desc_sw128(sv_s(s) + (kk / 4) * BN * 128 + off, 16), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > q0 + q_offset);
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = (i / 2) % 2, c = k0 + 8 * (i / 4) + f.cq;
      float p0 = ex2(fmaf(sc[i], scale_log2, -l2[r]));
      float p1 = ex2(fmaf(sc[i + 1], scale_log2, -l2[r]));
      if (edge) {
        if (c >= skv || (causal && c > rows[r] + q_offset)) p0 = 0.f;
        if (c + 1 >= skv || (causal && c + 1 > rows[r] + q_offset)) p1 = 0.f;
      }
      const float ds0 = p0 * (dp[i] - dl[r]) * scale;
      const float ds1 = p1 * (dp[i + 1] - dl[r]) * scale;
      dsf[i / 8][(i % 8) / 2] = pack_bf16(__floats2bfloat162_rn(ds0, ds1));
    }
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(dqa, dsf[kk], desc_sw128(sk_s(s) + kk * 16 * 128, BN * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
  store_rows<D>(dq, dqa, b, q0, sq, h, hh, d);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, float* delta, void* dq,
           void* dk, void* dv, int b, int sq, int skv, int h, int hkv, int d,
           int causal, int q_offset, float sm_scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel_wgmma<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, q, b, sq, h, d, BN) || !encode(&tdo, dout, b, sq, h, d, BN) ||
      !encode(&tk, k, b, skv, hkv, d, BN) || !encode(&tv, v, b, skv, hkv, d, BN))
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)b * sq * h;
  const auto* o16 = reinterpret_cast<const __nv_bfloat16*>(o);
  const auto* do16 = reinterpret_cast<const __nv_bfloat16*>(dout);
  if (d <= 64)
    flash_bwd_delta_kernel<8><<<(unsigned)((rows * 8 + 255) / 256), 256, 0,
                                stream>>>(o16, do16, delta, rows, sq, h, d);
  else
    flash_bwd_delta_kernel<16><<<(unsigned)((rows * 16 + 255) / 256), 256, 0,
                                 stream>>>(o16, do16, delta, rows, sq, h, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = sm_scale * kLog2e;
  flash_bwd_dkdv_kernel_wgmma<D>
      <<<dim3((unsigned)(b * hkv), (unsigned)((skv + BM - 1) / BM)), kThreads,
         smem, stream>>>(tq, tk, tv, tdo, lse, delta,
                         reinterpret_cast<__nv_bfloat16*>(dk),
                         reinterpret_cast<__nv_bfloat16*>(dv), sq, skv, h, hkv,
                         d, causal, q_offset, sm_scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel_wgmma<D>
      <<<dim3((unsigned)(b * h), (unsigned)((sq + BM - 1) / BM)), kThreads,
         smem, stream>>>(tq, tk, tv, tdo, lse, delta,
                         reinterpret_cast<__nv_bfloat16*>(dq), sq, skv, h, hkv,
                         d, causal, q_offset, sm_scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, o, do, dq: (b, sq, h, d); k, v, dk, dv: (b, skv, hkv, d); lse and
// delta (scratch, written here): (b, h, sq) f32. All contiguous, base
// addresses of q, k, v and do 16-byte aligned, d % 8 == 0, 8 <= d <= 128.
// Causal row i keeps the keys up to q_offset + i (q_offset >= 0).
extern "C" int repro_flash_bwd_wgmma(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const float* lse, const void* dout,
                                     float* delta, void* dq, void* dk,
                                     void* dv, int b, int sq, int skv, int h,
                                     int hkv, int d, int causal, int q_offset,
                                     float sm_scale, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || h % hkv != 0 || d < 8 || d > 128 || d % 8 != 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, sq, skv, h,
                      hkv, d, causal, q_offset, sm_scale, s);
  return launch<128>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, sq, skv, h,
                     hkv, d, causal, q_offset, sm_scale, s);
}
