// Bucket pack: gather a bucket's gradient leaves into its one contiguous
// flat buffer, each leaf at its LeafSlot offset, in one launch per bucket.
//
// Replaces: src/repro/kernels/bucket_pack.py::_copy_kernel, launched by
// packed_copy (pl.pallas_call at bucket_pack.py:34), together with the
// concatenate and zero-pad of pack_leaves that feed it.
//
// Bound on an H100 SXM: bytes. Each element is read once and written once
// (8 B per f32 gradient). Design: the launch takes a device table of
// (source pointer, destination byte offset, byte count) rows, one per leaf;
// blockIdx.y picks the leaf and the x blocks stride over its bytes. A leaf
// whose source and destination are both 16-byte aligned is copied in
// 16-byte words, else in 4-byte or single-byte words, so the copy is exact
// for every dtype (f32, bf16, int32) with no concatenate temporary.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
__device__ __forceinline__ void copy_words(const unsigned char* src,
                                           unsigned char* dst, int64_t nbytes,
                                           int64_t tid, int64_t stride) {
  const int64_t nw = nbytes / (int64_t)sizeof(W);
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  // four independent loads in flight per thread before their stores
  int64_t i = tid;
  for (; i + 3 * stride < nw; i += 4 * stride) {
    const W a = s[i], b = s[i + stride], c = s[i + 2 * stride],
            e = s[i + 3 * stride];
    d[i] = a;
    d[i + stride] = b;
    d[i + 2 * stride] = c;
    d[i + 3 * stride] = e;
  }
  for (; i < nw; i += stride) d[i] = s[i];
  for (int64_t j = nw * (int64_t)sizeof(W) + tid; j < nbytes; j += stride)
    dst[j] = src[j];
}

__global__ void pack_kernel(const long long* __restrict__ table,
                            unsigned char* __restrict__ out) {
  const int leaf = blockIdx.y;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(table[3 * leaf]);
  unsigned char* dst = out + table[3 * leaf + 1];
  const int64_t nbytes = table[3 * leaf + 2];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uintptr_t align = (uintptr_t)src | (uintptr_t)dst;
  if (align % 16 == 0)
    copy_words<uint4>(src, dst, nbytes, tid, stride);
  else if (align % 4 == 0)
    copy_words<uint32_t>(src, dst, nbytes, tid, stride);
  else
    copy_words<unsigned char>(src, dst, nbytes, tid, stride);
}

}  // namespace

// table: device array of n_leaves rows (src_ptr, dst_byte_offset, nbytes).
extern "C" int repro_bucket_pack(const long long* table, int n_leaves,
                                 void* out, long long max_nbytes,
                                 void* stream) {
  if (n_leaves <= 0 || max_nbytes <= 0) return (int)cudaSuccess;
  if (n_leaves > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (max_nbytes / 64 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  const dim3 grid((unsigned)blocks, (unsigned)n_leaves);
  pack_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      table, reinterpret_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}
