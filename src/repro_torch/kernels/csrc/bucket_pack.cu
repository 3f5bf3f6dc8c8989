// Bucket pack: gather a bucket's gradient leaves into its one contiguous
// flat buffer, each leaf at its LeafSlot offset, in one launch per bucket
// (per 128 leaves).
//
// Replaces: src/repro/kernels/bucket_pack.py::_copy_kernel, launched by
// packed_copy (pl.pallas_call at bucket_pack.py:34), together with the
// concatenate and zero-pad of pack_leaves that feed it.
//
// Bound on an H100 SXM: bytes. Each element is read once and written once
// (8 B per f32 gradient). Design:
// * The leaf table travels by value in the kernel's parameter block (a
//   __grid_constant__ struct of up to 128 rows of source address,
//   destination byte offset and byte count), so a launch needs no
//   allocation and no host-to-device copy before it.
// * The grid is 1-D over the bucket's 16-byte chunks, kChunksPerBlock to a
//   block, so every block has the same number of bytes to move whatever
//   the leaf sizes, and none is idle. A block finds the leaf of its first
//   chunk by binary search over the table's chunk prefix sums and walks on
//   through the leaves its range covers.
// * A leaf whose source and destination are both 16-byte aligned is copied
//   in 16-byte words, else in 4-byte or single-byte words, so the copy is
//   exact for every dtype (f32, bf16, int32) with no concatenate
//   temporary. On the card, 8 KiB blocks of 512 threads with one chunk a
//   thread beat larger blocks and more loads in flight a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 128;
constexpr int kThreads = 512;
constexpr unsigned kChunksPerBlock = kThreads;   // 8 KiB, a chunk a thread

}  // namespace

// One launch's leaves; first[i] is the number of 16-byte chunks (the last
// one of a leaf may be partial) in leaves 0..i-1. Matches
// repro_torch.kernels.build.PackTable.
struct PackTable {
  unsigned long long src[kMaxLeaves];      // source address
  unsigned long long dst[kMaxLeaves];      // byte offset into the bucket
  unsigned long long nbytes[kMaxLeaves];
  unsigned int first[kMaxLeaves + 1];
  int n;
};

namespace {

// Chunks [a, e) of one leaf, in words of type W.
template <typename W>
__device__ __forceinline__ void copy_chunks(const unsigned char* src,
                                            unsigned char* dst,
                                            unsigned long long nbytes,
                                            unsigned a, unsigned e) {
  struct Chunk { W w[16 / sizeof(W)]; };
  const Chunk* s = reinterpret_cast<const Chunk*>(src);
  Chunk* d = reinterpret_cast<Chunk*>(dst);
  const unsigned long long full = nbytes / 16;        // whole chunks
  const unsigned ef = (unsigned)min((unsigned long long)e, full);
  for (unsigned c = a + threadIdx.x; c < ef; c += kThreads) d[c] = s[c];
  if (threadIdx.x == 0 && a <= full && full < e)      // the partial last chunk
    for (unsigned long long i = full * 16; i < nbytes; ++i) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const __grid_constant__ PackTable t, unsigned char* out) {
  const unsigned c_begin = blockIdx.x * kChunksPerBlock;
  const unsigned c_end = min(c_begin + kChunksPerBlock, t.first[t.n]);
  int lo = 0, hi = t.n - 1;             // the last leaf with first <= c_begin
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.first[mid] <= c_begin) lo = mid;
    else hi = mid - 1;
  }
  for (int leaf = lo; leaf < t.n && t.first[leaf] < c_end; ++leaf) {
    const unsigned f = t.first[leaf];
    const unsigned a = max(c_begin, f) - f;
    const unsigned e = min(c_end, t.first[leaf + 1]) - f;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(t.src[leaf]);
    unsigned char* dst = out + t.dst[leaf];
    const uintptr_t align = (uintptr_t)src | (uintptr_t)dst;
    if (align % 16 == 0)
      copy_chunks<uint4>(src, dst, t.nbytes[leaf], a, e);
    else if (align % 4 == 0)
      copy_chunks<uint32_t>(src, dst, t.nbytes[leaf], a, e);
    else
      copy_chunks<unsigned char>(src, dst, t.nbytes[leaf], a, e);
  }
}

}  // namespace

extern "C" int repro_bucket_pack(PackTable table, void* out, void* stream) {
  if (table.n <= 0) return (int)cudaSuccess;
  if (table.n > kMaxLeaves) return (int)cudaErrorInvalidValue;
  const unsigned chunks = table.first[table.n];
  const unsigned blocks = (chunks + kChunksPerBlock - 1) / kChunksPerBlock;
  pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, reinterpret_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}
