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

namespace {

constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int BQ = 64 * kConsumers;              // query rows per block
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kBox = 64;                         // bf16 columns per TMA box
// a wait this long means a lost arrival: trap instead of hanging the card
constexpr long long kHangCycles = 20000000000LL;

constexpr int BK = 128;                          // kv rows per stage
constexpr int STAGES = 2;                        // K/V stages in the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// One box of a 4-D tensor map, (c0, c1, c2, c3) innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile whose 8-row
// groups are 1024 bytes apart (SBO); lbo is the stride between 64-column
// boxes, read only for an MN-major operand wider than one box.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- wgmma m64nNk16, bf16 x bf16 -> f32 ---------------------------------------
// ss (S = Q K^T, N = BK): A and B from shared memory, both K-major. rs
// (O += P V, N = D): A from registers, B MN-major (imm-trans-b = 1), always
// added to the accumulator.

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (b, s, heads, d) bf16, contiguous, as a 4-D map with (64, 1, rows, 1) boxes;
// columns past d read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int b, int s, int heads, int d,
            int rows) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
