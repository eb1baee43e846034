// RWKV6 ("Finch") chunked linear attention for Hopper (sm_90a), CUDA C++
// with a plain C interface (loaded with ctypes by
// repro_torch/kernels/rwkv6/rwkv6.py).
//
// Replaces the Pallas TPU kernel `_rwkv_kernel` / `rwkv6_chunked`
// (src/repro/kernels/rwkv6/rwkv6.py:22-92) and computes the function of the
// JAX package's `ssm.rwkv6_chunked`: per (batch, head) the recurrence
//   o_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t,
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,
// with a K x V f32 state that may come in and always goes out (prefill
// hands the final state to decode; the TPU kernel neither takes nor returns
// it). r, k, v, u are f32 or bf16, logw and the state f32, all arithmetic
// f32. The output is in r's dtype.
//
// Translation of the Pallas grid (B*H, n_chunks): its chunk axis runs in
// order with the state in VMEM scratch. CUDA blocks run in no set order, so
// one CTA owns one (batch, head) and loops over the sequence, the state in
// shared memory (16 KiB at K = V = 64). The loop takes sub-chunks of
// kSub = 16 steps whatever the caller's chunk: the function is the
// recurrence, so the sub-chunk is the kernel's own choice. Inside a
// sub-chunk the products are taken relative to its start, as the reference
// does (k_s e^{-cum_s} against r_t e^{cum_{t-1}}); 16 steps keep
// e^{-cum} far from f32's limit even under strong decay. Inputs are read at
// their (N, S, H, K) layout, one step's K channels contiguous at stride
// H * K, so the wrapper makes no transposed copies.
//
// Per sub-chunk, with 256 threads: load r, k, v, logw (zeros past the
// end, which add nothing); one thread per channel takes the inclusive
// cumsum of logw; the decayed r, k and the state-update weights
// k_s e^{tot - cum_s}; the 16 x 16 matrix A (decayed scores below the
// diagonal, the bonus r.(u*k) on it); o = (decayed r) @ S + A @ v; then
// S <- e^{tot} S + (weighted k)^T @ v. Rows of the K-wide tiles are padded
// by one float so that a warp reading one channel across 16 steps hits 16
// banks.
//
// What bounds it on this card: at the serving shapes (48 or 32 steps, 256
// CTAs) neither bytes nor FLOPs -- the bound is a few microseconds -- but
// the sequential sub-chunk loop: six barriers per 16 steps and the latency
// of each step's loads. No tensor cores, TMA or double buffering yet: this
// is the simple correct kernel; wgmma tiles and a pipelined load belong to
// a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 16;          // steps per sub-chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// r, k, v, logw, o: (N, S, H, K) (V == K); u: (G, H, K), batch row n reads
// u row n / u_div; state_in (may be null), state_out: (N, H, K, K).
// grid.x = N * H, one CTA per (batch, head); block = kThreads.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const T* __restrict__ u, const float* __restrict__ state_in,
                 T* __restrict__ o, float* __restrict__ state_out, int S,
                 int H, long long u_div) {
  constexpr int V = K;
  constexpr int KP = K + 1;
  __shared__ float st[K][V];        // the carried state
  __shared__ float rs[kSub][KP];
  __shared__ float ks[kSub][KP];
  __shared__ float vs[kSub][V];
  __shared__ float cs[kSub][KP];    // logw, then its inclusive cumsum
  __shared__ float qd[kSub][KP];    // r_t e^{cum_{t-1}}
  __shared__ float kd[kSub][KP];    // k_s e^{-cum_s}
  __shared__ float kw[kSub][KP];    // k_s e^{tot - cum_s}
  __shared__ float A[kSub][kSub + 1];
  __shared__ float us[K];
  __shared__ float wt[K];           // e^{tot}

  const long long bh = blockIdx.x;
  const long long n = bh / H;
  const int h = static_cast<int>(bh % H);
  const int tid = threadIdx.x;
  const long long step = static_cast<long long>(H) * K;
  const long long base = n * S * step + static_cast<long long>(h) * K;

  for (int i = tid; i < K * V; i += kThreads)
    st[i / V][i % V] = state_in ? state_in[bh * K * V + i] : 0.f;
  for (int i = tid; i < K; i += kThreads)
    us[i] = to_f32(u[(n / u_div) * step + static_cast<long long>(h) * K + i]);

  for (int t0 = 0; t0 < S; t0 += kSub) {
    const int T = min(kSub, S - t0);
    for (int i = tid; i < kSub * K; i += kThreads) {
      const int t = i / K, c = i % K;
      float rv = 0.f, kv = 0.f, vv = 0.f, lv = 0.f;
      if (t < T) {
        const long long off = base + (t0 + t) * step + c;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        lv = logw[off];
      }
      rs[t][c] = rv;
      ks[t][c] = kv;
      vs[t][c] = vv;
      cs[t][c] = lv;
    }
    __syncthreads();
    if (tid < K) {
      float c = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        c += cs[t][tid];
        cs[t][tid] = c;
      }
      wt[tid] = expf(c);
    }
    __syncthreads();
    for (int i = tid; i < kSub * K; i += kThreads) {
      const int t = i / K, c = i % K;
      const float cum = cs[t][c];
      const float before = t ? cs[t - 1][c] : 0.f;
      const float tot = cs[kSub - 1][c];
      qd[t][c] = rs[t][c] * expf(before);
      kd[t][c] = ks[t][c] * expf(-cum);
      kw[t][c] = ks[t][c] * expf(tot - cum);
    }
    __syncthreads();
    for (int i = tid; i < kSub * kSub; i += kThreads) {
      const int t = i / kSub, s = i % kSub;
      float a = 0.f;
      if (s < t) {
#pragma unroll 16
        for (int c = 0; c < K; ++c) a += qd[t][c] * kd[s][c];
      } else if (s == t) {
#pragma unroll 16
        for (int c = 0; c < K; ++c) a += rs[t][c] * us[c] * ks[t][c];
      }
      A[t][s] = a;
    }
    __syncthreads();
    for (int i = tid; i < T * V; i += kThreads) {
      const int t = i / V, j = i % V;
      float acc = 0.f;
#pragma unroll 16
      for (int c = 0; c < K; ++c) acc += qd[t][c] * st[c][j];
      for (int s = 0; s <= t; ++s) acc += A[t][s] * vs[s][j];
      store(o + base + (t0 + t) * step + j, acc);
    }
    __syncthreads();
    for (int i = tid; i < K * V; i += kThreads) {
      const int c = i / V, j = i % V;
      float acc = wt[c] * st[c][j];
      for (int s = 0; s < T; ++s) acc += kw[s][c] * vs[s][j];
      st[c][j] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < K * V; i += kThreads)
    state_out[bh * K * V + i] = st[i / V][i % V];
}

template <typename T, int K>
cudaError_t launch_k(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* state_in,
                     void* o, void* state_out, long long N, int S, int H,
                     long long u_div, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(N * H));
  rwkv6_fwd_kernel<T, K><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const T*>(u), static_cast<const float*>(state_in),
      static_cast<T*>(o), static_cast<float*>(state_out), S, H, u_div);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int K, const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* state_in,
                     void* o, void* state_out, long long N, int S, int H,
                     long long u_div, cudaStream_t s) {
  switch (K) {
    case 16:
      return launch_k<T, 16>(r, k, v, logw, u, state_in, o, state_out, N, S,
                             H, u_div, s);
    case 32:
      return launch_k<T, 32>(r, k, v, logw, u, state_in, o, state_out, N, S,
                             H, u_div, s);
    case 64:
      return launch_k<T, 64>(r, k, v, logw, u, state_in, o, state_out, N, S,
                             H, u_div, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (r, k, v, u, o). r, k, v, logw, o: (N, S, H, K)
// contiguous; u: (G, H, K) with G dividing N; state_in: (N, H, K, K) f32 or
// null (zeros); state_out: (N, H, K, K) f32. K = V in {16, 32, 64}. Returns
// the cudaError_t of the launch (0 on success); nothing is synchronized and
// nothing allocated.
int repro_rwkv6_chunked(int dtype, int K, const void* r, const void* k,
                        const void* v, const void* logw, const void* u,
                        const void* state_in, void* o, void* state_out,
                        long long N, int S, int H, long long G,
                        void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 || G <= 0 || N % G ||
      N * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long u_div = N / G;
  if (dtype == 0)
    return launch_t<float>(K, r, k, v, logw, u, state_in, o, state_out, N,
                           S, H, u_div, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(K, r, k, v, logw, u, state_in, o,
                                   state_out, N, S, H, u_div, s);
  return cudaErrorInvalidValue;
}

const char* repro_rwkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
