// Flash-attention forward for bf16 on Hopper's tensor cores:
// softmax(q k^T / sqrt(d)) v with an online softmax, emitting o in bf16 and
// the row log-sum-exp (lse, natural log) in f32, at any head_dim d that is a
// multiple of 8 up to 128.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, launched by
// flash_attention (pl.pallas_call at flash_attention.py:80), for bf16 inputs.
// Two instances, D = 64 (d <= 64) and D = 128 (d above that): the TMA unit
// reads d columns and zero-fills the box to D, zero columns of q and k add
// nothing to q k^T, and the output columns of v's zero columns are never
// stored. So d = 80 does 128/80 = 1.6x the products of an exact instance.
// The TMA unit needs 16-byte global strides, hence d % 8 == 0. f32 inputs,
// and bf16 at any other d, take the mma.sync kernel in flash_attention.cu
// (flash_attention.py::route picks).
//
// Bound on an H100 SXM: operations. At the main path's shape (b=2, s=2048,
// h=32, kv=4, d=64, causal) one call is 34.4 GFLOP of products (q k^T and
// p v over the s(s+1)/2 causal pairs) against ~38 MB of q/k/v/o/lse
// traffic: 0.0348 ms at 989 TFLOP/s, against 0.011 ms for the bytes. This
// kernel does p v twice (below), 51.6 GFLOP of tensor-core work, so its own
// floor is 0.052 ms. What the design does about that bound:
//
// * Tensor cores. Both products are wgmma.mma_async, bf16 x bf16 -> f32.
//   Two consumer warpgroups own 64 query rows each (BQ = 128). S = Q K^T
//   reads Q and a K tile from shared memory (K-major); O += P V takes P
//   from registers as the A operand (the S accumulator's fragment is the
//   A fragment's layout, so it is converted in place) and V from shared
//   memory in its MN-major layout (d contiguous), so V is never transposed.
//   K/V tiles are 128 rows, in two stages (a third, or 64-row tiles, made
//   no difference or were slower on the card). Within a warpgroup the two
//   products and the softmax run in turn; the other warpgroup fills the
//   gaps. ptxas gives each thread 168 registers (the block is budgeted as
//   three warpgroups), and a software pipeline that overlaps tile j's
//   softmax with tile j-1's P V needs more: it spilled and was slower.
// * Asynchronous K/V tiles. One producer warp keeps a ring of STAGES K/V
//   tiles filled with TMA (cp.async.bulk.tensor, 128-byte swizzle, mbarrier
//   completion) while the consumers compute on the current one. q, k and v
//   are strided (b, s, heads, d) tensors, each described by a 4-D tensor
//   map encoded on the host at every call; at d=128 a tile is two 64-column
//   boxes. Rows past s are zero-filled by the TMA unit and masked here.
// * Precision of P. Rounding P to bf16 before P V (as FA2/FA3 do) misses
//   the port's limit for o (1e-2*|ref| + 1e-4, see chip_smoke.py) by up to
//   10x (tools/flash_p_precision.py emulates it). P is split into two bf16 terms, P_hi =
//   bf16(P) and P_lo = bf16(P - P_hi), and both are multiplied by the same
//   V tile into one f32 accumulator: P is carried to ~16 bits, at 1.5x the
//   forward's tensor-core work. Scores need no such care: bf16 products
//   are exact in the f32 accumulator.
// * Online softmax in f32 registers: exp2 with sm_scale*log2(e) folded into
//   the scores, O rescaled only when a row's max moves, l summed from the
//   f32 P before it is rounded.
// * Causal (top-left, qpos >= kpos): kv tiles past the block's diagonal are
//   never loaded, a warpgroup skips a tile wholly above its rows, and only
//   tiles that cross the diagonal or the ragged end of s are masked. The
//   longest q tiles are launched first so the causal tail is short.
// * GQA by head index: q head hh reads kv head hh / (h / hkv); pre-expanded
//   kv (hkv == h) takes the same path.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int BQ = 64 * kConsumers;              // query rows per block
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int BK = 128;                          // kv rows per stage
constexpr int STAGES = 2;                        // K/V stages in the ring

// q, o: (b, sq, h, d); k, v: (b, skv, hkv, d); lse: (b, h, sq); d <= D. The
// tensor maps describe q, k, v as (d, heads, s, b), innermost first, and
// their boxes are D columns wide. Causal row i keeps the keys up to
// q_offset + i.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int sq, int skv, int h, int hkv, int d, int causal,
                       int q_offset, float scale_log2) {
  constexpr int NBOX = D / kBox;
  constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms must start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq_tile = base;
  const uint32_t sk0 = base + Q_BYTES;                    // stage s: K, then V
  const uint32_t bars = sk0 + STAGES * 2 * KV_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto sk = [&](int s) { return sk0 + (uint32_t)(s * 2 * KV_BYTES); };
  auto sv = [&](int s) { return sk(s) + (uint32_t)KV_BYTES; };

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;      // longest tiles first
  const int kv_end = causal ? min(skv, min(q0 + BQ, sq) + q_offset) : skv;
  const int n_kv = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * kConsumers) {
    // producer: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int x = 0; x < NBOX; ++x)
        tma_load(sq_tile + x * BQ * 128, &tq, q_full, x * kBox, hh, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * KV_BYTES);
        for (int x = 0; x < NBOX; ++x) {
          tma_load(sk(s) + x * BK * 128, &tk, full(s), x * kBox, kvh, j * BK,
                   b);
          tma_load(sv(s) + x * BK * 128, &tv, full(s), x * kBox, kvh, j * BK,
                   b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns rows q0 + 64*wg .. +63; this thread holds
  // rows r0 and r0 + 8 of them, columns 8*i + 2*(lane%4) + {0, 1}
  const int wg = warp / 4;
  const int rw0 = q0 + 64 * wg;                  // the warpgroup's first row
  const int r0 = rw0 + 16 * (warp % 4) + lane / 4;
  const int rows[2] = {r0, r0 + 8};
  const int cq = 2 * (lane % 4);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  const uint32_t qa = sq_tile + wg * 64 * 128;
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BK;
    mbar_wait(full(s), (j / STAGES) & 1);
    if (!(causal && k0 > rw0 + 63 + q_offset)) {   // else wholly above
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns into the box
        wgmma_ss_n128(sc, desc_sw128(qa + (kk / 4) * BQ * 128 + off, 16),
                     desc_sw128(sk(s) + (kk / 4) * BK * 128 + off, 16), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      if (k0 + BK > skv || (causal && k0 + BK - 1 > rw0 + q_offset)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + cq + (i % 2);
          const int row = rows[(i / 2) % 2];
          if (col >= skv || (causal && col > row + q_offset))
            sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mnew = fmaxf(m[r], mx[r] * scale_log2);
        if (mnew != m[r]) {                    // rescale only on a new max
          const float corr = ex2(m[r] - mnew);
          l[r] *= corr;
#pragma unroll
          for (int i = 0; i < D / 2; ++i)
            if ((i / 2) % 2 == r) acc[i] *= corr;
          m[r] = mnew;
        }
        mb[r] = m[r] == -INFINITY ? 0.f : m[r];
      }
      uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i / 2) % 2;
        const float p0 = ex2(fmaf(sc[i], scale_log2, -mb[r]));
        const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -mb[r]));
        l[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi));
        phi[i / 8][(i % 8) / 2] = pack_bf16(hi);
        plo[i / 8][(i % 8) / 2] = pack_bf16(lo);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, phi[kk], desc_sw128(sv(s) + kk * 16 * 128, BK * 128));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, plo[kk], desc_sw128(sv(s) + kk * 16 * 128, BK * 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));      // this warp is done with stage s
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* op = o + (((int64_t)b * sq + row) * h + hh) * d + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (8 * c >= d) continue;                // a zero-filled column of v
      const __nv_bfloat162 x = __floats2bfloat162_rn(
          acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * c) = x;
    }
    if (lane % 4 == 0)
      lse[((int64_t)b * h + hh) * sq + row] =
          m[r] * 0.6931471805599453f + logf(l[r]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int skv, int h, int hkv, int d, int causal,
           int q_offset, float sm_scale, cudaStream_t stream) {
  constexpr int smem = 1024 + BQ * D * 2 + STAGES * 2 * BK * D * 2 +
                       8 * (1 + 2 * STAGES);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, b, sq, h, d, BQ) || !encode(&tk, k, b, skv, hkv, d, BK) ||
      !encode(&tv, v, b, skv, hkv, d, BK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  flash_fwd_kernel_wgmma<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, reinterpret_cast<__nv_bfloat16*>(o), lse, sq, skv, h, hkv,
      d, causal, q_offset, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, o: (b, sq, h, d); k, v: (b, skv, hkv, d); lse: (b, h, sq) f32.
// All contiguous, base addresses 16-byte aligned, d % 8 == 0, 8 <= d <= 128.
// Causal row i keeps the keys up to q_offset + i (q_offset >= 0).
extern "C" int repro_flash_fwd_wgmma(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int b, int sq, int skv, int h, int hkv,
                                     int d, int causal, int q_offset,
                                     float sm_scale, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || h % hkv != 0 || d < 8 || d > 128 || d % 8 != 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64>(q, k, v, o, lse, b, sq, skv, h, hkv, d, causal,
                      q_offset, sm_scale, s);
  return launch<128>(q, k, v, o, lse, b, sq, skv, h, hkv, d, causal,
                     q_offset, sm_scale, s);
}
