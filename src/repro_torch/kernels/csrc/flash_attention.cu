// Flash-attention forward on Hopper's tensor cores through mma.sync, for f32
// at any head_dim from 1 to 256 and for the bf16 head dims the wgmma kernel
// does not take: softmax(q k^T / sqrt(d)) v with an online softmax, emitting
// o in q's dtype and the row log-sum-exp (lse, natural log) in f32.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, launched by
// flash_attention (pl.pallas_call at flash_attention.py:80), for f32 inputs
// and for bf16 at a head_dim that is not a multiple of 8 or is above 128
// (flash_attention.py::route picks; flash_attention_wgmma.cu takes the rest).
//
// Bound on an H100 SXM: operations. At the main path's shape in f32 (b=2,
// s=2048, h=32, kv=4, d=64, causal) one call is 34.4 GFLOP of products (q k^T
// and p v over the s(s+1)/2 causal pairs) against ~77 MB of q/k/v/o/lse
// traffic (0.023 ms). On the f32 units (67 TFLOP/s) that is 0.513 ms. This
// kernel runs each product three times on the TF32 tensor cores (below):
// 3 x 34.4 GFLOP at 495 TFLOP/s dense TF32, 0.208 ms; at the rate mma.sync
// alone reaches on an H100 (about 300 TFLOP/s, tools/flash_mma_variants.py)
// 0.33 ms. The products take about half of this kernel's time; the loads,
// the syncs and the softmax are not hidden under them. What the design does:
//
// * Tensor cores, 3xTF32. Both products are mma.sync m16n8k8 with TF32
//   operands and an f32 accumulator. TF32 keeps 10 mantissa bits, too few
//   for the port's f32 limits (o within 2e-5, lse within 1e-4), so each f32
//   operand x is split into hi = tf32(x) and lo = tf32(x - hi) (both round
//   to nearest) and a product is lo*hi + hi*lo + hi*hi into one accumulator:
//   about 21 bits, the lo*lo term (2^-22 of the product) dropped. bf16 is
//   exact in TF32, so on the bf16 path only P is split (two products). The
//   scale is applied to the scores, not to q, so q stays exact for bf16.
//   mma.sync and not wgmma: TF32 wgmma takes only K-major operands from
//   shared memory, so P V would need V transposed (it is stored d-major);
//   mma.sync takes its fragments from registers.
// * Fragments by permutation, not by shuffle. A product sums over k in any
//   order as long as A's columns and B's rows agree, and its output columns
//   may be any columns as long as the store puts them back. So:
//   - q k^T: in each 16 columns of d, thread t reads columns 4t..4t+3 of q
//     and k with one vector load and feeds them as k = t, t+4 of two k-steps;
//   - P V: the S accumulator holds P[g][2t], P[g][2t+1] (and row g+8) of
//     each 8-column tile, where the A fragment wants columns t and t+4; they
//     are fed as k = t and t+4, and the B fragment reads V's rows 2t and
//     2t+1 to match. (bf16's m16n8k16 reuses the accumulator in place;
//     TF32's m16n8k8 would otherwise need quad shuffles);
//   - V and O: thread g reads V columns 4g..4g+3 of each 32 with one vector
//     load, one column for each of four 8-column output tiles, and so ends
//     up holding 8 contiguous output columns, stored whole.
//   Shared-memory rows are padded so that these vector loads are free of
//   bank conflicts (q and k: 16 elements; v: 4 floats or 8 bf16).
// * Independent products in a row: within a k-step every tile's lo*hi comes
//   before any tile's hi*lo and hi*hi, so consecutive mma.sync never wait on
//   one accumulator.
// * Tiling. Four warps. Up to D = 64 each owns two m16 tiles of query rows
//   (BQ = 128), so every K and V fragment it loads and splits feeds two
//   products (10% faster at the f32 main shape than one m-tile and 64-row
//   kv tiles, tools/flash_mma_variants.py); above, one (BQ = 64), for
//   registers. kv tiles of 32 rows (16 at D = 256). Two blocks an SM.
//   Templated on the padded width D in {16, 32, 64, 128, 256}: columns at
//   and past the true d are zero-filled on load and add nothing to q k^T,
//   and output columns past d are never stored. The accumulator is D/2
//   floats a thread and m-tile; q stays in shared memory and its fragments
//   are loaded (and split) per k-step.
// * Asynchronous tiles. q and a ring of STAGES K/V tiles are filled with
//   cp.async copies zero-filled past s and d: 16 bytes (cp.async.cg) where
//   d's rows are whole 16-byte chunks and the tensors 16-byte aligned, else
//   8 or 4 bytes; bf16 at an odd d by element loads with zero fill.
// * Online softmax in registers: each thread holds two rows' running max
//   and sum, reduced over the quad with __shfl_xor_sync; exp2 with
//   sm_scale*log2(e) folded into the scores; O and the sum rescaled by
//   exp2(old max - new max) on every tile, 1 where the max held (against
//   rescaling under a branch: no difference beyond the runs' noise).
// * Causal (top-left, qpos >= kpos, as the Pallas kernel and the model):
//   kv tiles past the block's diagonal are never loaded, a warp skips a tile
//   wholly above its rows, and only tiles that cross the diagonal or the
//   ragged end of s are masked. The longest q tiles are launched first.
// * GQA by head index: q head hh reads kv head hh / (h / hkv); pre-expanded
//   kv (hkv == h) takes the same path.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int STAGES = 2;         // K/V tiles in the ring

// m16 tiles of query rows a warp owns: two up to D = 64, so each K and V
// fragment is split once for two products; one above (registers)
template <int D>
__host__ __device__ constexpr int m_tiles() { return D <= 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int q_rows() { return 16 * m_tiles<D>() * kWarps; }
template <int D>
__host__ __device__ constexpr int kv_rows() {
  return D >= 256 ? 16 : 32;
}

// Row strides of the shared tiles, in elements. q and k are read 4 columns
// a thread at rows g = 0..7: a stride of 16 (mod 32) words for f32, and of 8
// or 24 (mod 32) words for bf16, spreads each phase of the vector loads over
// all 32 banks. v is read at rows 2t and 2t+1: a stride of 4 (mod 16) words
// for f32, 8 (mod 32) elements for bf16.
template <int D>
__host__ __device__ constexpr int qk_stride() { return D == 16 ? 16 : D + 16; }
template <typename T, int D>
__host__ __device__ constexpr int v_stride() {
  return std::is_same<T, float>::value ? D + 4 : D + 8;
}
// V columns a thread reads at once, one for each of that many output tiles
template <int D>
__host__ __device__ constexpr int v_group() { return D >= 32 ? 4 : 2; }

template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  return (q_rows<D>() * qk_stride<D>() +
          STAGES * kv_rows<D>() * (qk_stride<D>() + v_stride<T, D>())) *
         (int)sizeof(T);
}

__device__ __forceinline__ void from_f(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// N consecutive elements of a shared tile, as floats, in one load.
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const __nv_bfloat16* p) {
  uint32_t w[N / 2];
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// CB bytes global -> shared, or CB zeros (and no read) where !ok.
template <int CB>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const int n = ok ? CB : 0;
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
                 "l"(src), "n"(CB), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x = hi + lo, each a TF32 value rounded to nearest (ties away from zero,
// as cvt.rna.tf32.f32 rounds); for an input already exact in TF32 (bf16)
// only hi is formed. The rounding is an add of half a TF32 step to the
// bits: mma.sync reads only a TF32 operand's top 19 bits, so lo needs no
// mask, and hi is masked only because x - hi needs its value. On the card
// this ran the f32 main shape 13% faster than cvt.rna.tf32.f32
// (tools/flash_mma_variants.py).
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c += a b, m16n8k8, TF32 inputs, f32 accumulator. a: rows g, g+8 at
// columns t, t+4 (a0 g/t, a1 g+8/t, a2 g/t+4, a3 g+8/t+4); b: rows t, t+4
// at column g; c: rows g (c0, c1) and g+8 (c2, c3) at columns 2t, 2t+1,
// where g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a b[i] for N output tiles to ~21 bits: every tile's small terms
// first, then every tile's hi*hi. Without SPLIT_B (bf16 b, exact in TF32):
// a_lo*b + a_hi*b.
template <bool SPLIT_B, int N>
__device__ __forceinline__ void mma3(float (*c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[N][2],
                                     const uint32_t (&blo)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], alo, bhi[i][0], bhi[i][1]);
  if constexpr (SPLIT_B) {
#pragma unroll
    for (int i = 0; i < N; ++i) mma(c[i], ahi, blo[i][0], blo[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], ahi, bhi[i][0], bhi[i][1]);
}

// Rows row0 .. row0+R-1 of head hd of a (b, s, heads, d) tensor into a
// (R, RS) shared tile, columns 0 .. D-1, in CB-byte asynchronous copies;
// rows past s and columns past d are zeros.
template <typename T, int D, int R, int RS, int CB>
__device__ __forceinline__ void load_chunks(T* dst, const T* __restrict__ src,
                                            int b, int row0, int s, int heads,
                                            int hd, int d) {
  constexpr int E = CB / (int)sizeof(T);     // elements per chunk
  constexpr int CPR = D / E;                 // chunks per row
  for (int i = threadIdx.x; i < R * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * E, row = row0 + r;
    const bool ok = row < s && c < d;
    const T* g = ok ? src + (((int64_t)b * s + row) * heads + hd) * d + c : src;
    cp_async<CB>(smem_u32(dst + r * RS + c), g, ok);
  }
}

// The same in chunks of cb bytes (16, 8 or 4: what divides a row and the
// tensors' alignment), or element by element with plain loads (cb 0: bf16
// at an odd d).
template <typename T, int D, int R, int RS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int b, int row0, int s, int heads,
                                          int hd, int d, int cb) {
  if (cb == 16) return load_chunks<T, D, R, RS, 16>(dst, src, b, row0, s,
                                                    heads, hd, d);
  if (cb == 8) return load_chunks<T, D, R, RS, 8>(dst, src, b, row0, s, heads,
                                                  hd, d);
  if (cb == 4) return load_chunks<T, D, R, RS, 4>(dst, src, b, row0, s, heads,
                                                  hd, d);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D, row = row0 + r;
    if (row < s && c < d)
      dst[r * RS + c] = src[(((int64_t)b * s + row) * heads + hd) * d + c];
    else
      from_f(dst + r * RS + c, 0.f);
  }
}

// N contiguous output columns from col on, those below d; whole (16-byte or
// 8-byte stores) when vec and all N are below d.
template <int N>
__device__ __forceinline__ void store_run(float* dst, const float (&x)[N],
                                          int col, int d, bool vec) {
  if (vec && col + N <= d) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col + i < d) dst[i] = x[i];
}
template <int N>
__device__ __forceinline__ void store_run(__nv_bfloat16* dst,
                                          const float (&x)[N], int col, int d,
                                          bool vec) {
  if (vec && col + N <= d) {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (N == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col + i < d) from_f(dst + i, x[i]);
}

// q, o: (b, sq, h, d); k, v: (b, skv, hkv, d); lse: (b, h, sq). Contiguous;
// d <= D. cb: the bytes of one asynchronous copy (load_tile); vec: o's rows
// are whole 16-byte chunks at 16-byte aligned addresses. Two blocks an SM,
// which lets ptxas give a thread up to 255 registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel_mma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int h, int hkv,
                     int d, int causal, float scale_log2, int cb, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int MT = m_tiles<D>();
  constexpr int BQ = q_rows<D>();
  constexpr int BK = kv_rows<D>();
  constexpr int RQ = qk_stride<D>();
  constexpr int RV = v_stride<T, D>();
  constexpr int GW = v_group<D>();
  constexpr int NS = BK / 8;   // 8-column tiles of S, k-steps of P V
  constexpr int NO = D / 8;    // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq_tile = reinterpret_cast<T*>(smem_raw);
  auto sk = [&](int s) { return sq_tile + BQ * RQ + s * BK * (RQ + RV); };
  auto sv = [&](int s) { return sk(s) + BK * RQ; };

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;      // longest tiles first
  const int kv_end = causal ? min(skv, min(q0 + BQ, sq)) : skv;
  const int n_kv = (kv_end + BK - 1) / BK;

  // the first STAGES-1 groups: q with kv tile 0, then tiles 1 .. STAGES-2
  load_tile<T, D, BQ, RQ>(sq_tile, q, b, q0, sq, h, hh, d, cb);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kv) {
      load_tile<T, D, BK, RQ>(sk(s), k, b, s * BK, skv, hkv, kvh, d, cb);
      load_tile<T, D, BK, RV>(sv(s), v, b, s * BK, skv, hkv, kvh, d, cb);
    }
    cp_async_commit();
  }

  // the warp owns rows rw0 .. rw0 + 16*MT - 1; this thread's row r (of 2*MT)
  // is row g + 8*r of them: rows g and g+8 of m-tile r/2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw0 = q0 + 16 * MT * warp;
  int rows[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) rows[r] = rw0 + g + 8 * r;
  const T* qf = sq_tile + (16 * MT * warp + g) * RQ + 4 * t;

  float acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  float m[2 * MT], l[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<STAGES - 2>();                 // tile j (and q) landed
    __syncthreads();                             // ... for every thread
    {                                            // refill the stage of j-1
      const int jn = j + STAGES - 1;
      if (jn < n_kv) {
        load_tile<T, D, BK, RQ>(sk(jn % STAGES), k, b, jn * BK, skv, hkv, kvh,
                                d, cb);
        load_tile<T, D, BK, RV>(sv(jn % STAGES), v, b, jn * BK, skv, hkv, kvh,
                                d, cb);
      }
      cp_async_commit();
    }
    const int k0 = j * BK;
    if (causal && k0 > rw0 + 16 * MT - 1) continue;   // wholly above our rows
    const T* kf = sk(j % STAGES) + g * RQ + 4 * t;
    const T* vf = sv(j % STAGES) + 2 * t * RV + GW * g;

    // S = Q K^T for the warp's rows and BK columns, 16 columns of d at a
    // time: columns 4t, 4t+1 are k = t, t+4 of the first k-step, 4t+2, 4t+3
    // of the second. Each K fragment is split once for all MT m-tiles.
    float sc[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][n][e] = 0.f;
#pragma unroll
    for (int c16 = 0; c16 < D / 16; ++c16) {
      uint32_t bhi[2][NS][2], blo[2][NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float kx[4];
        lds<4>(kx, kf + 8 * n * RQ + 16 * c16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split<SPLIT>(kx[e], bhi[e / 2][n][e % 2], blo[e / 2][n][e % 2]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float qa[4], qb[4];
        lds<4>(qa, qf + 16 * mt * RQ + 16 * c16);          // row g
        lds<4>(qb, qf + (16 * mt + 8) * RQ + 16 * c16);    // row g + 8
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t ahi[4], alo[4];
          split<SPLIT>(qa[2 * ks], ahi[0], alo[0]);
          split<SPLIT>(qb[2 * ks], ahi[1], alo[1]);
          split<SPLIT>(qa[2 * ks + 1], ahi[2], alo[2]);
          split<SPLIT>(qb[2 * ks + 1], ahi[3], alo[3]);
          if constexpr (SPLIT) {
            mma3<true, NS>(sc[mt], ahi, alo, bhi[ks], blo[ks]);
          } else {                               // bf16 x bf16: exact
#pragma unroll
            for (int n = 0; n < NS; ++n)
              mma(sc[mt][n], ahi, bhi[ks][n][0], bhi[ks][n][1]);
          }
        }
      }
    }

    // element e of S tile n of m-tile mt is row 2*mt + e/2, column
    // k0 + 8n + 2t + e%2
    if (k0 + BK > skv || (causal && k0 + BK - 1 > rw0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (col >= skv || (causal && col > rows[2 * mt + e / 2]))
              sc[mt][n][e] = -INFINITY;
          }
    }
    float mb[2 * MT];
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
      const int mt = r / 2, h2 = 2 * (r % 2);
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(sc[mt][n][h2], sc[mt][n][h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[r], mx * scale_log2);
      const float corr = mnew == m[r] ? 1.f : ex2(m[r] - mnew);
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[mt][n][h2] *= corr;
        acc[mt][n][h2 + 1] *= corr;
      }
      m[r] = mnew;
      mb[r] = m[r] == -INFINITY ? 0.f : m[r];
    }

    // O += P V: S tile n is k-step n, its columns 2t and 2t+1 fed as k = t
    // and t + 4 (a0..a3 = P[g][2t], P[g+8][2t], P[g][2t+1], P[g+8][2t+1]),
    // so the B fragment is V's rows 2t and 2t+1; V column GW*g + i of each
    // 8*GW is column g of output tile GW*cg + i. Each V fragment is split
    // once for all MT m-tiles.
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(sc[mt][n][e], scale_log2, -mb[2 * mt + e / 2]));
          l[2 * mt + e / 2] += p[e];
        }
        split<true>(p[0], ahi[mt][0], alo[mt][0]);
        split<true>(p[2], ahi[mt][1], alo[mt][1]);
        split<true>(p[1], ahi[mt][2], alo[mt][2]);
        split<true>(p[3], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int cg = 0; cg < NO / GW; ++cg) {
        float v0[GW], v1[GW];
        lds<GW>(v0, vf + 8 * n * RV + 8 * GW * cg);        // row 2t
        lds<GW>(v1, vf + (8 * n + 1) * RV + 8 * GW * cg);  // row 2t + 1
        uint32_t bhi[GW][2], blo[GW][2];
#pragma unroll
        for (int i = 0; i < GW; ++i) {
          split<SPLIT>(v0[i], bhi[i][0], blo[i][0]);
          split<SPLIT>(v1[i], bhi[i][1], blo[i][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3<SPLIT, GW>(acc[mt] + GW * cg, ahi[mt], alo[mt], bhi, blo);
      }
    }
  }
  cp_async_wait<0>();                            // no copy outlives the block

  // output tile GW*cg + i, column 2t + e is column 8*GW*cg + GW*(2t + e) + i:
  // 2*GW contiguous columns a thread and row
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    const int mt = r / 2, h2 = 2 * (r % 2);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = rows[r];
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* op = o + (((int64_t)b * sq + row) * h + hh) * d;
#pragma unroll
    for (int cg = 0; cg < NO / GW; ++cg) {
      float x[2 * GW];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < GW; ++i)
          x[GW * e + i] = acc[mt][GW * cg + i][h2 + e] * inv;
      const int col = 8 * GW * cg + 2 * GW * t;
      store_run<2 * GW>(op + col, x, col, d, vec);
    }
    if (t == 0)
      lse[((int64_t)b * h + hh) * sq + row] =
          m[r] * 0.6931471805599453f + logf(l[r]);
  }
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, T* o, float* lse, int b,
           int sq, int skv, int h, int hkv, int d, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, D>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int row_bytes = d * (int)sizeof(T);
  const uintptr_t in = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  int cb = 16;
  while (cb >= 4 && (row_bytes % cb || in % cb)) cb /= 2;
  if (cb < 4) cb = 0;
  const int vec = row_bytes % 16 == 0 && (((uintptr_t)o | in) & 15u) == 0;
  constexpr int BQ = q_rows<D>();
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + BQ - 1) / BQ));
  flash_fwd_kernel_mma<T, D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, sq, skv, h, hkv, d, causal,
      sm_scale * 1.4426950408889634f, cb, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int b, int sq, int skv, int h, int hkv, int d, int causal,
             float sm_scale, cudaStream_t s) {
  const T* qt = reinterpret_cast<const T*>(q);
  const T* kt = reinterpret_cast<const T*>(k);
  const T* vt = reinterpret_cast<const T*>(v);
  T* ot = reinterpret_cast<T*>(o);
#define REPRO_FLASH_CASE(DIM)                                               \
  if (d <= DIM)                                                             \
    return launch<T, DIM>(qt, kt, vt, ot, lse, b, sq, skv, h, hkv, d, causal, \
                          sm_scale, s);
  REPRO_FLASH_CASE(16)
  REPRO_FLASH_CASE(32)
  REPRO_FLASH_CASE(64)
  REPRO_FLASH_CASE(128)
  REPRO_FLASH_CASE(256)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: (b, sq, h, d); k, v: (b, skv, hkv, d); lse: (b, h, sq) f32. All
// contiguous, f32 or (is_bf16) bf16, 1 <= d <= 256.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int b, int sq, int skv,
                               int h, int hkv, int d, int causal, int is_bf16,
                               float sm_scale, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || h % hkv != 0 || d < 1 || d > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, b, sq, skv, h, hkv, d,
                                   causal, sm_scale, s);
  return dispatch<float>(q, k, v, o, lse, b, sq, skv, h, hkv, d, causal,
                         sm_scale, s);
}
