// PE-assisted reordering (tile swizzle) for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by repro_torch/kernels/reorder/
// reorder.py).
//
// Replaces the Pallas TPU kernel `_copy_kernel` / `tile_swizzle_p`
// (src/repro/kernels/reorder/reorder.py:23-51): out row-block i = in
// row-block perm[i] of a (G*b, D) array. There the permutation is a
// scalar-prefetch operand that drives the DMA of one VMEM tile per grid
// step; here `perm` is an int32 tensor on the device that each CTA reads for
// its own block. The port's all_to_all is this kernel: in the cube layout an
// all_to_all over a group is one permutation of contiguous blocks of the
// stored cube tensor, across all instances at once.
//
// What bounds it on this card: the bytes. It does no arithmetic; every input
// byte is read once and every output byte written once, so its bound is
// 2 * G * b * D * itemsize / 3.35 TB/s. The design keeps the traffic at that:
// each block is a contiguous span of b * D * itemsize bytes, copied by one or
// more CTAs with the widest vector the alignment of both base pointers and
// of the block size allows (16 bytes, else 8, 4 or 2), neighbouring threads
// on neighbouring words so every warp access is coalesced, and each thread
// issues all its loads before its stores so several are in flight. A block
// may be as small as one row or a part of one; the host sizes the CTA to
// the block (32 to 256 threads). No shared memory, TMA or clusters: a later
// change may replace the loads with TMA bulk copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;          // words in flight per thread
constexpr long long kMaxGridY = 65535;

// out block i <- x block perm[i], words of type W (16, 8, 4 or 2 bytes).
// grid.x = G (one destination block each), grid.y = chunks of a block;
// a perm entry outside [0, G) writes a zero block.
template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
tile_swizzle_kernel(const W* __restrict__ x, W* __restrict__ out,
                    const int* __restrict__ perm, long long G,
                    long long block_words) {
  const long long i = blockIdx.x;
  const int src = perm[i];
  W* dst = out + i * block_words;
  const long long chunk = (long long)blockDim.x * kUnroll;
  const long long step = (long long)gridDim.y * chunk;
  if (src < 0 || src >= G) {
    for (long long base = blockIdx.y * chunk; base < block_words;
         base += step) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long w = base + (long long)u * blockDim.x + threadIdx.x;
        if (w < block_words) dst[w] = W();
      }
    }
    return;
  }
  const W* s = x + (long long)src * block_words;
  for (long long base = blockIdx.y * chunk; base < block_words;
       base += step) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = base + (long long)u * blockDim.x + threadIdx.x;
      if (w < block_words) v[u] = s[w];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = base + (long long)u * blockDim.x + threadIdx.x;
      if (w < block_words) dst[w] = v[u];
    }
  }
}

template <typename W>
cudaError_t launch_w(const void* x, void* out, const int* perm, long long G,
                     long long block_bytes, cudaStream_t stream) {
  const long long words = block_bytes / (long long)sizeof(W);
  long long threads = ((words + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  long long chunks = (words + threads * kUnroll - 1) / (threads * kUnroll);
  if (chunks > kMaxGridY) chunks = kMaxGridY;
  dim3 grid((unsigned)G, (unsigned)chunks);
  tile_swizzle_kernel<W><<<grid, (unsigned)threads, 0, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out), perm, G, words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: G contiguous blocks of `block_bytes` bytes each (the wrapper's
// (G*b, D) tensor); perm: G int32 on the device. Returns the cudaError_t of
// the launch (0 on success); nothing is synchronized and nothing allocated.
int repro_tile_swizzle(const void* x, void* out, const void* perm,
                       long long G, long long block_bytes, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(block_bytes);
  if (G <= 0 || G > 0x7fffffffLL || block_bytes <= 0 || a % 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
  if (a % 16 == 0) return launch_w<uint4>(x, out, p, G, block_bytes, s);
  if (a % 8 == 0) return launch_w<uint2>(x, out, p, G, block_bytes, s);
  if (a % 4 == 0) return launch_w<unsigned int>(x, out, p, G, block_bytes, s);
  return launch_w<unsigned short>(x, out, p, G, block_bytes, s);
}

const char* repro_reorder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
