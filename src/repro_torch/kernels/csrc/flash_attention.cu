// Flash-attention forward: softmax(q k^T / sqrt(d)) v with an online
// softmax, emitting o in q's dtype and the row log-sum-exp (lse) in f32.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, launched by
// flash_attention (pl.pallas_call at flash_attention.py:80).
//
// Bound on an H100 SXM: operations. At the main path's shape (b=2, s=2048,
// h=32, d=64, causal) one call is ~34.4 GFLOP of products against ~38 MB of
// q/k/v/o traffic, so the tensor cores' 989 TFLOP/s would bound it at
// ~0.035 ms. This first version does not reach the tensor cores: scores and
// the value product run on the f32 units, one thread per query row.
// Design: one block per (batch*head, 64-row q tile); K/V stream through
// shared memory in 32-row tiles (converted to f32 on load), never holding
// the whole (s, d) K/V as the Pallas BlockSpec does; the running max, sum
// and accumulator stay in registers in f32; causal masking is top-left
// (qpos >= kpos, as the Pallas kernel and the model mask) and kv tiles past
// the q tile's diagonal are never loaded. GQA is folded into indexing:
// query head hh reads kv head hh / (h / hkv), so kv is never expanded (and
// pre-expanded kv, hkv == h, takes the same path).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block (one thread each)
constexpr int BK = 32;   // kv rows per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// q, o: (b, sq, h, D); k, v: (b, skv, hkv, D); lse: (b, h, sq). Contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int skv, int h, int hkv,
                 int causal, float sm_scale) {
  // D <= 64: at 128 the per-thread q and accumulator rows spill
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int q0 = blockIdx.y * BQ;
  const int row = q0 + threadIdx.x;
  const bool valid = row < sq;

  float qr[D], acc[D];
  if (valid) {
    const T* qp = q + (((int64_t)b * sq + row) * h + hh) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = to_f(qp[c]) * sm_scale;
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float mi = -INFINITY, li = 0.f;

  // causal: the last row of this tile sees keys up to q0 + BQ - 1
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * D; idx += blockDim.x) {
      const int j = idx / D, c = idx % D, kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < skv) {
        const int64_t off = (((int64_t)b * skv + kj) * hkv + kvh) * D + c;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j][c] = kx;
      vs[j][c] = vx;
    }
    __syncthreads();
    if (!valid) continue;
    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot += qr[c] * ks[j][c];
      const int kj = k0 + j;
      const bool ok = kj < skv && (!causal || kj <= row);
      s[j] = ok ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    if (tmax == -INFINITY) continue;   // no visible key in this tile
    const float mnew = fmaxf(mi, tmax);
    const float corr = expf(mi - mnew);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - mnew);
      psum += s[j];
    }
    li = li * corr + psum;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] += s[j] * vs[j][c];
    }
    mi = mnew;
  }
  if (valid) {
    const float inv = 1.f / fmaxf(li, 1e-30f);
    T* op = o + (((int64_t)b * sq + row) * h + hh) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) from_f(op + c, acc[c] * inv);
    lse[((int64_t)b * h + hh) * sq + row] = mi + logf(li);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int skv, int h, int hkv, int d, int causal,
           float sm_scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  const T* qt = reinterpret_cast<const T*>(q);
  const T* kt = reinterpret_cast<const T*>(k);
  const T* vt = reinterpret_cast<const T*>(v);
  T* ot = reinterpret_cast<T*>(o);
#define REPRO_FLASH_CASE(DIM)                                              \
  case DIM:                                                                \
    flash_fwd_kernel<T, DIM><<<grid, BQ, 0, stream>>>(                     \
        qt, kt, vt, ot, lse, sq, skv, h, hkv, causal, sm_scale);           \
    break;
  switch (d) {
    REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int b, int sq, int skv,
                               int h, int hkv, int d, int causal, int is_bf16,
                               float sm_scale, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || h % hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, b, sq, skv, h, hkv, d,
                                 causal, sm_scale, s);
  return launch<float>(q, k, v, o, lse, b, sq, skv, h, hkv, d, causal,
                       sm_scale, s);
}
