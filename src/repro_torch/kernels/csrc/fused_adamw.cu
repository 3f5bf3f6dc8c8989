// Fused AdamW: one read-modify-write pass over a flat parameter buffer,
// updating p, m and v in place.
//
// Replaces: src/repro/kernels/fused_adamw.py::_adamw_kernel, launched by
// fused_adamw_flat (pl.pallas_call at fused_adamw.py:74).
//
// Bound on an H100 SXM: bytes. Per f32 parameter it reads p, g, m, v (16 B)
// and writes p, m, v (12 B): 28 B against ~15 flops; 22 B with a bf16 p.
// Design: a grid-stride loop with 16-byte vector loads where every pointer
// is aligned, and a masked scalar tail instead of padding the buffer. All
// scalars are computed once on the host in f32, and every operation is a
// correctly rounded intrinsic (no FMA contraction; this file is also built
// with -fmad=false), so the result is bitwise equal to the plain PyTorch
// version in repro_torch/kernels/ref.py::adamw_ref.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct AdamWArgs {
  float scale, b1, omb1, b2, omb2, bc1, bc2, lr, eps, wd;
};

struct __align__(8) Bf16x4 {
  __nv_bfloat16 x[4];
};

// Same operation order as ref.adamw_ref, one rounding per operation.
__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, const AdamWArgs& a) {
  const float gs = __fmul_rn(g, a.scale);
  const float mn = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(gs, a.omb1));
  const float vn = __fadd_rn(__fmul_rn(v, a.b2),
                             __fmul_rn(__fmul_rn(gs, a.omb2), gs));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, a.bc2)), a.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fdiv_rn(mn, a.bc1), den),
                              __fmul_rn(p, a.wd));
  p = __fadd_rn(p, -__fmul_rn(upd, a.lr));
  m = mn;
  v = vn;
}

__device__ __forceinline__ float load_p(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_p(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_p(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_p(__nv_bfloat16* p, int64_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load_p4(const float* p, int64_t i, float* out) {
  const float4 t = reinterpret_cast<const float4*>(p)[i];
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load_p4(const __nv_bfloat16* p, int64_t i,
                                        float* out) {
  const Bf16x4 t = reinterpret_cast<const Bf16x4*>(p)[i];
  for (int j = 0; j < 4; ++j) out[j] = __bfloat162float(t.x[j]);
}
__device__ __forceinline__ void store_p4(float* p, int64_t i, const float* x) {
  reinterpret_cast<float4*>(p)[i] = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_p4(__nv_bfloat16* p, int64_t i,
                                         const float* x) {
  Bf16x4 t;
  for (int j = 0; j < 4; ++j) t.x[j] = __float2bfloat16_rn(x[j]);
  reinterpret_cast<Bf16x4*>(p)[i] = t;
}

template <typename P>
__global__ void adamw_kernel(P* __restrict__ p, const float* __restrict__ g,
                             float* __restrict__ m, float* __restrict__ v,
                             int64_t n, AdamWArgs a, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t tail = 0;
  if (vec) {
    const int64_t nv = n / 4;
    for (int64_t i = tid; i < nv; i += stride) {
      const float4 g4 = reinterpret_cast<const float4*>(g)[i];
      float4 m4 = reinterpret_cast<const float4*>(m)[i];
      float4 v4 = reinterpret_cast<const float4*>(v)[i];
      float pp[4];
      load_p4(p, i, pp);
      adamw_one(pp[0], g4.x, m4.x, v4.x, a);
      adamw_one(pp[1], g4.y, m4.y, v4.y, a);
      adamw_one(pp[2], g4.z, m4.z, v4.z, a);
      adamw_one(pp[3], g4.w, m4.w, v4.w, a);
      store_p4(p, i, pp);
      reinterpret_cast<float4*>(m)[i] = m4;
      reinterpret_cast<float4*>(v)[i] = v4;
    }
    tail = nv * 4;
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    float pi = load_p(p, i), mi = m[i], vi = v[i];
    adamw_one(pi, g[i], mi, vi, a);
    store_p(p, i, pi);
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename P>
int launch(P* p, const float* g, float* m, float* v, long long n,
           AdamWArgs a, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const uintptr_t align = (uintptr_t)g | (uintptr_t)m | (uintptr_t)v;
  const uintptr_t palign = (uintptr_t)p % (4 * sizeof(P));
  const int vec = (align % 16 == 0) && palign == 0;
  const int threads = 256;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  adamw_kernel<P><<<(unsigned)blocks, threads, 0, stream>>>(p, g, m, v, n, a,
                                                             vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_adamw_f32(float* p, const float* g, float* m, float* v,
                               long long n, float scale, float b1, float omb1,
                               float b2, float omb2, float bc1, float bc2,
                               float lr, float eps, float wd, void* stream) {
  AdamWArgs a{scale, b1, omb1, b2, omb2, bc1, bc2, lr, eps, wd};
  return launch<float>(p, g, m, v, n, a, (cudaStream_t)stream);
}

extern "C" int repro_adamw_bf16(void* p, const float* g, float* m, float* v,
                                long long n, float scale, float b1, float omb1,
                                float b2, float omb2, float bc1, float bc2,
                                float lr, float eps, float wd, void* stream) {
  AdamWArgs a{scale, b1, omb1, b2, omb2, bc1, bc2, lr, eps, wd};
  return launch<__nv_bfloat16>(reinterpret_cast<__nv_bfloat16*>(p), g, m, v,
                               n, a, (cudaStream_t)stream);
}
