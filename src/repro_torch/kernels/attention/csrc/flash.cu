// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by repro_torch/kernels/attention/flash.py).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention`
// (src/repro/kernels/attention/flash.py): causal / sliding-window GQA
// attention, f32 online softmax, finite NEG_INF = -1e30 (a fully masked row
// averages v, as the TPU kernel's does), output / max(l, 1e-30). It also
// returns the f32 partials (acc, m, l) that flash-decode LSE-combines
// across cache shards.
//
// Positions come from int32 device tensors (query (B, Sq), key (B, Sk)),
// the rule for the TPU kernel's scalar-prefetched / static offsets: prefill
// passes offset + arange, decode passes each row's position and the
// rolling slot positions. Visibility: k_pos >= 0, k_pos <= q_pos when
// causal, q_pos - k_pos < window when window > 0.
//
// What bounds it on this card: at decode (one query row per head against a
// short cache chunk) the bytes -- every K/V element is read once per CTA,
// and each CTA serves one (batch, kv head) with all its query heads, so
// GQA groups share one read of the tile. At the serving shapes of this
// repository the forward pass is bytes-bound too (a few dozen keys).
//
// Design, one CTA per (batch, kv head, tile of WARPS query rows): a query
// row is one (position, head-in-group) pair, so a decode step puts all G
// heads of a kv group into one CTA. The sequential kv grid axis of the TPU
// kernel becomes a loop inside the CTA over key tiles of 32 staged in
// shared memory (f32; K padded by one column so that lane j reading key j
// hits distinct banks). Each warp owns one query row: lane j scores key j,
// the warp reduces max and sum with shuffles, and each lane accumulates
// its head-dim slice of p @ V. m, l and acc stay in registers in f32.
// No tensor cores or TMA yet: this is the simple correct kernel; wgmma
// tiles belong to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kAbsent = -3.0e38f;  // below kNegInf: keys past Sk
constexpr int kWarps = 4;      // query rows per CTA
constexpr int kTile = 32;      // keys per shared-memory tile (one per lane)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// q, out: (B, Sq, H, HD); k, v: (B, Sk, KV, HD); q_pos: (B, Sq);
// k_pos: (B, Sk). acc: (B, H, Sq, HD), m, l: (B, H, Sq) (partial form).
// grid.x = B * KV, grid.y = ceil(Sq * G / kWarps); block = 32 * kWarps.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kWarps)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ k_pos, T* __restrict__ out,
                 float* __restrict__ acc_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int Sq, int Sk, int H, int KV,
                 int causal, int window, float scale) {
  constexpr int kPer = (HD + 31) / 32;   // head-dim entries per lane
  __shared__ float ks[kTile][HD + 1];
  __shared__ float vs[kTile][HD];
  __shared__ float qs[kWarps][HD];
  __shared__ int kp[kTile];

  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.y * kWarps + warp;   // (position, group member)
  const bool active = row < Sq * G;             // uniform within a warp
  const int qi = active ? row / G : 0;
  const int h = kvh * G + (active ? row % G : 0);

  const size_t q_off = ((size_t)(b * Sq + qi) * H + h) * HD;
  for (int d = lane; d < HD; d += 32)
    qs[warp][d] = active ? to_f32(q[q_off + d]) * scale : 0.f;
  const int qp = active ? q_pos[(size_t)b * Sq + qi] : 0;

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    __syncthreads();   // the previous tile (and qs) is consumed / written
    for (int e = threadIdx.x; e < kTile * HD; e += blockDim.x) {
      const int j = e / HD, d = e % HD, s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < Sk) {
        const size_t off = ((size_t)(b * Sk + s) * KV + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    if (threadIdx.x < kTile) {
      const int s = k0 + threadIdx.x;
      kp[threadIdx.x] = s < Sk ? k_pos[(size_t)b * Sk + s] : 0;
    }
    __syncthreads();
    if (!active) continue;

    // lane j scores key k0 + j
    const bool exists = k0 + lane < Sk;
    float sc = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) sc += qs[warp][d] * ks[lane][d];
    const int kpj = kp[lane];
    bool vis = kpj >= 0;
    if (causal) vis = vis && kpj <= qp;
    if (window > 0) vis = vis && (qp - kpj) < window;
    sc = vis ? sc : kNegInf;

    const float m_new = fmaxf(m, warp_max(exists ? sc : kAbsent));
    const float p = exists ? expf(sc - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
    const int n = min(kTile, Sk - k0);
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) acc[i] += pj * vs[j][d];
      }
    }
    m = m_new;
  }

  if (!active) return;
  if (out != nullptr) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) store(out + q_off + d, acc[i] * inv);
    }
  }
  if (acc_out != nullptr) {
    const size_t r = (size_t)(b * H + h) * Sq + qi;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) acc_out[r * HD + d] = acc[i];
    }
    if (lane == 0) {
      m_out[r] = m;
      l_out[r] = l;
    }
  }
}

template <typename T>
cudaError_t launch_t(int hd, dim3 grid, dim3 block, cudaStream_t stream,
                     const void* q, const void* k, const void* v,
                     const int* qp, const int* kp, void* out, float* acc,
                     float* m, float* l, int Sq, int Sk, int H, int KV,
                     int causal, int window, float scale) {
#define REPRO_FLASH_CASE(HD_)                                                 \
  case HD_:                                                                   \
    flash_fwd_kernel<T, HD_><<<grid, block, 0, stream>>>(                     \
        static_cast<const T*>(q), static_cast<const T*>(k),                   \
        static_cast<const T*>(v), qp, kp, static_cast<T*>(out), acc, m, l,    \
        Sq, Sk, H, KV, causal, window, scale);                                \
    break;
  switch (hd) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Either `out`
// (normalized output) or all of `acc`, `m`, `l` (partials) may be null.
// Returns the cudaError_t of the launch (0 on success); nothing is
// synchronized and nothing is allocated.
int repro_flash_attention(int dtype, const void* q, const void* k,
                          const void* v, const void* q_pos, const void* k_pos,
                          void* out, void* acc, void* m, void* l, int B,
                          int Sq, int Sk, int H, int KV, int hd, int causal,
                          int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return cudaErrorInvalidValue;
  const int G = H / KV;
  dim3 grid(B * KV, (Sq * G + kWarps - 1) / kWarps);
  dim3 block(32 * kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (dtype == 0)
    return launch_t<float>(hd, grid, block, s, q, k, v, qp, kp, out, a, mm,
                           ll, Sq, Sk, H, KV, causal, window, scale);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(hd, grid, block, s, q, k, v, qp, kp, out,
                                   a, mm, ll, Sq, Sk, H, KV, causal, window,
                                   scale);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
