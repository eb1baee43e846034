// PE-assisted reordering (tile swizzle) for Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by repro_torch/kernels/reorder/
// reorder.py).
//
// Replaces the Pallas TPU kernel `_copy_kernel` / `tile_swizzle_p`
// (src/repro/kernels/reorder/reorder.py:23-51): out row-block i = in
// row-block perm[i] of a (G*b, D) array. There the permutation is a
// scalar-prefetch operand that drives the DMA of one VMEM tile per grid
// step; here `perm` is an int32 tensor on the device that the kernel reads.
// The port's all_to_all is this kernel: in the cube layout an all_to_all
// over a group is one permutation of contiguous blocks of the stored cube
// tensor, across all instances at once. A perm entry outside [0, G) writes
// a zero block.
//
// What bounds it on this card: the bytes. It does no arithmetic; every input
// byte is read once and every output byte written once, so its bound is
// 2 * G * b * D * itemsize / 3.35 TB/s.
//
// The design: threads over the flat output of n = G * block_words words,
// whatever the block size. A word is the widest that the alignment of both
// base pointers and of the block size allows (16 bytes, else 8, 4 or 2).
// Word w lies in block i = w / block_words at offset w - i * block_words;
// its source is word perm[i] * block_words + offset, or zero. Neighbouring
// lanes take neighbouring output words, so a warp writes 32 contiguous
// words and reads whole source blocks, with no lane idle at any block size.
// Below 2^31 words the indices are 32-bit and the divide is a 31-bit
// magic-number multiply (`__umulhi` by a multiplier the host computes, as
// block_words is any number: 52 for DLRM); above, they are 64-bit with a
// plain divide (4 GB and up at 2-byte words; no traffic of the port gets
// there). The host (`reorder.plan`) gives the word, the index width, the
// CTA (256 threads), the grid (one word a thread, so n / 256 CTAs) and the
// divisor; the entry point recomputes them and refuses anything else. One
// launch a call.
//
// The design before it ran one CTA per destination block, sized to the
// block: a 256-byte block was one warp with half its lanes idle and one
// 16-byte load a thread, a quarter of the bound on the prefill K/V
// reshards. On the H100 80GB HBM3 at 700 W (PERF.md §6): blocks of 128 B
// to 1.25 MiB reach 80-85% of the bound at 64 MiB of payload, the 256-byte
// reshards 3.1x faster than before; 16-byte blocks 37%, each word a
// separate random 16-byte read under the 32-byte sector. Two richer forms
// ran no faster (tools/reorder_ab.py against copies of them): a persistent
// grid of 4 CTAs an SM with 4 words a thread was 2-7% slower on 64 MiB
// (one gathered word a thread at full occupancy already keeps enough bytes
// in flight, and the CTA scheduler balances the last wave better than a
// fixed split), and a second kernel of CTAs over (block, chunk) pairs for
// blocks over 4 KiB was at most 2% faster from 32 KiB up. No shared
// memory, TMA or clusters: each word goes through registers once, at
// index_select's rate on large blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxWords32 = 0x7fffffffLL;  // the 32-bit index's range
constexpr long long kMaxGrid = 0x7fffffffLL;     // grid.x

// The 31-bit magic divisor of d >= 1: for every n < 2^31,
// n / d == (d == 1 ? n : __umulhi(n, mul) >> shr), with l = ceil(log2 d),
// mul = ceil(2^(31 + l) / d) (< 2^32) and shr = l - 1. `reorder.magic`
// computes the same pair on the host.
void magic(long long d, unsigned* mul, unsigned* shr) {
  if (d == 1) {
    *mul = 0;
    *shr = 0;
    return;
  }
  unsigned l = 0;
  while ((1LL << l) < d) ++l;
  const unsigned long long p = 1ULL << (31 + l);
  *mul = (unsigned)((p + (unsigned long long)d - 1) / (unsigned long long)d);
  *shr = l - 1;
}

// The block of word w: the magic divide on 32-bit indices (mul 0 for
// block_words 1), a plain divide on 64-bit ones.
__device__ __forceinline__ unsigned block_of(unsigned w, unsigned,
                                             unsigned mul, unsigned shr) {
  return mul ? __umulhi(w, mul) >> shr : w;
}
__device__ __forceinline__ unsigned long long block_of(
    unsigned long long w, unsigned long long bw, unsigned, unsigned) {
  return w / bw;
}

// out word w <- x word perm[w / bw] * bw + w % bw, or zero, for w in
// [0, n), n = G * bw; a thread takes one word an iteration. With the
// planned grid (n / blockDim.x CTAs) the loop runs once; it strides only
// if n / blockDim.x passes grid.x's limit. On 32-bit indices w + step
// stays under 2^32, as n < 2^31 and step <= n + blockDim.x.
template <typename W, typename I>
__global__ void __launch_bounds__(kThreads)
swizzle(const W* __restrict__ x, W* __restrict__ out,
        const int* __restrict__ perm, I G, I bw, I n, unsigned mul,
        unsigned shr) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I w = (I)blockIdx.x * blockDim.x + threadIdx.x; w < n; w += step) {
    const I i = block_of(w, bw, mul, shr);
    const unsigned p = (unsigned)perm[i];   // a negative entry is >= G too
    out[w] = p < G ? x[(I)p * bw + (w - i * bw)] : W();
  }
}

template <typename W>
cudaError_t launch(const void* x, void* out, const int* perm, long long G,
                   long long bw, int index_bits, long long grid,
                   unsigned mul, unsigned shr, cudaStream_t s) {
  const W* xw = static_cast<const W*>(x);
  W* ow = static_cast<W*>(out);
  if (index_bits == 32)
    swizzle<W, unsigned><<<(unsigned)grid, kThreads, 0, s>>>(
        xw, ow, perm, (unsigned)G, (unsigned)bw, (unsigned)(G * bw), mul,
        shr);
  else
    swizzle<W, unsigned long long><<<(unsigned)grid, kThreads, 0, s>>>(
        xw, ow, perm, G, bw, G * bw, 0, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: G contiguous blocks of `block_bytes` bytes each (the wrapper's
// (G*b, D) tensor); perm: G int32 on the device. The rest is the geometry
// of `reorder.plan`: `width` the word in bytes (the widest of 16, 8, 4, 2
// dividing both pointers and block_bytes), `index_bits` 32 below 2^31
// words and 64 from there, `threads` 256, `grid` one CTA per 256 words (at
// most grid.x's limit), and the 32-bit divisor (mul, shr; 0 on 64 bits).
// Returns the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue without launching on a geometry that is not the
// plan's; nothing is synchronized and nothing allocated.
int repro_tile_swizzle(const void* x, void* out, const void* perm,
                       long long G, long long block_bytes, int width,
                       int index_bits, int threads, long long grid,
                       unsigned mul, unsigned shr, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(block_bytes);
  const int widest = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4
                     : a % 2 == 0 ? 2 : 0;
  if (G <= 0 || G > 0x7fffffffLL || block_bytes <= 0 || widest == 0 ||
      width != widest || threads != kThreads)
    return cudaErrorInvalidValue;
  const long long bw = block_bytes / width;
  if (bw > 0x7fffffffffffffffLL / G) return cudaErrorInvalidValue;
  const long long n = G * bw;
  const long long ctas = (n + kThreads - 1) / kThreads;
  unsigned m = 0, s = 0;
  if (n <= kMaxWords32) magic(bw, &m, &s);
  if (index_bits != (n <= kMaxWords32 ? 32 : 64) || mul != m || shr != s ||
      grid != (ctas < kMaxGrid ? ctas : kMaxGrid))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
  switch (width) {
    case 16: return launch<uint4>(x, out, p, G, bw, index_bits, grid, mul,
                                  shr, st);
    case 8: return launch<uint2>(x, out, p, G, bw, index_bits, grid, mul,
                                 shr, st);
    case 4: return launch<unsigned int>(x, out, p, G, bw, index_bits, grid,
                                        mul, shr, st);
    default: return launch<unsigned short>(x, out, p, G, bw, index_bits,
                                           grid, mul, shr, st);
  }
}

const char* repro_reorder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
