// RWKV6 ("Finch") chunked recurrence, backward, for Hopper (sm_90a), CUDA
// C++ with a plain C interface (loaded with ctypes by
// repro_torch/kernels/rwkv6/rwkv6_bwd.py).
//
// Replaces no Pallas kernel: the JAX package trains RWKV6 by jax.grad of
// the jnp `ssm.rwkv6_chunked` (src/repro/models/ssm.py:21); its forward's
// TPU kernel is `_rwkv_kernel` (src/repro/kernels/rwkv6/rwkv6.py:73),
// ported as rwkv6.cu. This is the gradient of that function: from (r, k,
// v, logw, u, the saved states, do, dstate_out or null) it returns dr, dk,
// dv (in r's type), dlogw (f32), du (u's type, summed in f32 over the rows
// that share one u) and dstate_in (f32, when a state came in), with
//   o_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t,
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T.
//
// Design. The forward kernel, asked for them, saves the f32 state at the
// start of each of its 16-step sub-chunks: (N, H, n_sub, K, V). One CTA
// per (batch, head) sweeps the sub-chunks last to first, carrying dS (the
// gradient of the sub-chunk's end state) in shared memory. Within a
// sub-chunk it rebuilds the forward's decayed operands from logw -- qd =
// r e^{excl}, kd = k e^{-cum}, kw = k e^{tot - cum} (cum inclusive, excl
// = cum - logw, tot = cum at the last step) -- and with S0 the saved start
// state, P[t, s] = qd_t . kd_s, dP[t, s] = do_t . v_s (s < t), D_t =
// r_t . (u k_t), dD_t = do_t . v_t:
//   dqd_t = S0 do_t + sum_{s<t} dP[t, s] kd_s
//   dkd_s = sum_{t>s} dP[t, s] qd_t,        dkw_s = dS v_s
//   dv_s  = sum_{t>s} P[t, s] do_t + D_s do_s + dS^T kw_s
//   dr = dqd e^{excl} + u k dD,   dk = dkd e^{-cum} + dkw e^{tot-cum}
//        + u r dD,                du += sum_t r_t k_t dD_t
//   dlogw_tau = sum_{t>=tau} (a_t + b_t) - b_tau + dtot: a = -(dkd kd +
//        dkw kw) through cum, b = dqd qd through excl, dtot = sum_s dkw_s
//        kw_s + e^{tot} rowsum(S0 * dS) -- the gradient of the inclusive
//        cumulative log-decay summed back over the sub-chunk (the identity
//        chunked gated-linear-attention backwards use) plus the state term
//   dS <- e^{tot} dS + sum_t qd_t do_t^T.
// The 16-step sub-chunk keeps e^{-cum} far from f32's range under strong
// decay, as in the forward. Steps past S are zero (r, k, v, do) with logw
// 0: they add nothing. ref.rwkv6_chunked_backward is the same algorithm in
// PyTorch.
//
// Deterministic: no atomics. Each CTA writes its per-row du into an f32
// scratch (N, H, K); a second kernel sums the rows that share a u in row
// order and writes du in u's type.
//
// What bounds it: a simple first form, all f32 on CUDA cores with every
// operand in shared memory (rows padded by one float, so a warp's column
// reads hit 32 banks), seven barriers a sub-chunk and no prefetch; about
// 240 FMAs per (step, channel), most with two shared-memory loads. The
// bound (bytes or f32 operations) and its time at the training shape are
// in PERF.md section 6; tensor cores, as in the forward, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 16;  // steps per sub-chunk: the forward's

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One sub-chunk's operands, f32. Step-major [kSub][K + 1] and state
// [K][K + 1] rows are padded by one float.
template <int K>
struct Smem {
  static constexpr int KP = K + 1;
  float r[kSub][KP], k[kSub][KP], v[kSub][KP], d_o[kSub][KP];
  float lw[kSub][KP], cum[kSub][KP];
  float qd[kSub][KP], kd[kSub][KP], kw[kSub][KP];
  float dqd[kSub][KP], dkd[kSub][KP], dkw[kSub][KP];
  float s0[K][KP], ds[K][KP];
  float p[kSub][kSub], dp[kSub][kSub];
  float dd[kSub], dg[kSub];  // D_t, dD_t
  float tot[K], wt[K], us[K];
};

// r, k, v, d_o, dr, dk, dv: (N, S, H, K) in T (V == K); logw, dlogw: (N,
// S, H, K) f32; u: (G, H, K) in T, row n reads u row n / u_div; states:
// (N, H, n_sub, K, K) f32; dstate_out (may be null), dstate_in (may be
// null): (N, H, K, K) f32; du_rows: (N, H, K) f32. grid = N * H, block =
// 4 K threads.
template <typename T, int K>
__global__ void __launch_bounds__(4 * K)
rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ logw,
                 const T* __restrict__ u, const float* __restrict__ states,
                 const T* __restrict__ d_o,
                 const float* __restrict__ dstate_out, T* __restrict__ dr,
                 T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ dlogw, float* __restrict__ du_rows,
                 float* __restrict__ dstate_in, int S, int H,
                 long long u_div) {
  constexpr int V = K;
  constexpr int NT = 4 * K;
  constexpr int CK = kSub * K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<K>& sm = *reinterpret_cast<Smem<K>*>(smem_raw);

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long n = bh / H;
  const int h = static_cast<int>(bh % H);
  const long long step = static_cast<long long>(H) * K;
  const long long base = n * S * step + static_cast<long long>(h) * K;
  const int nsub = (S + kSub - 1) / kSub;

  for (int c = tid; c < K; c += NT)
    sm.us[c] = to_f32(u[(n / u_div) * step + static_cast<long long>(h) * K
                        + c]);
  for (int i = tid; i < K * V; i += NT) {
    const int c = i / V, j = i % V;
    sm.ds[c][j] = dstate_out ? dstate_out[bh * K * V + i] : 0.f;
  }
  float du_acc = 0.f;  // channel tid's du (tid < K)

  for (int sub = nsub - 1; sub >= 0; --sub) {
    const int t0 = sub * kSub;
    // 1. the sub-chunk's inputs and its saved start state
    for (int i = tid; i < CK; i += NT) {
      const int t = i / K, c = i % K;
      const bool in = t0 + t < S;
      const long long off = base + static_cast<long long>(t0 + t) * step + c;
      sm.r[t][c] = in ? to_f32(r[off]) : 0.f;
      sm.k[t][c] = in ? to_f32(k[off]) : 0.f;
      sm.v[t][c] = in ? to_f32(v[off]) : 0.f;
      sm.d_o[t][c] = in ? to_f32(d_o[off]) : 0.f;
      sm.lw[t][c] = in ? logw[off] : 0.f;
    }
    const float* s0 = states + (bh * nsub + sub) * K * V;
    for (int i = tid; i < K * V; i += NT) sm.s0[i / V][i % V] = s0[i];
    __syncthreads();

    // 2. cum, tot and the decayed operands, one channel a thread
    if (tid < K) {
      const int c = tid;
      float acc = 0.f;
      for (int t = 0; t < kSub; ++t) {
        acc += sm.lw[t][c];
        sm.cum[t][c] = acc;
      }
      sm.tot[c] = acc;
      sm.wt[c] = expf(acc);
      for (int t = 0; t < kSub; ++t) {
        const float cu = sm.cum[t][c];
        sm.qd[t][c] = sm.r[t][c] * expf(cu - sm.lw[t][c]);
        sm.kd[t][c] = sm.k[t][c] * expf(-cu);
        sm.kw[t][c] = sm.k[t][c] * expf(acc - cu);
      }
    }
    __syncthreads();

    // 3. P, dP below the diagonal; D, dD on it
    for (int i = tid; i < kSub * kSub; i += NT) {
      const int t = i / kSub, s = i % kSub;
      float a = 0.f, b = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int c = 0; c < K; ++c) {
          a += sm.qd[t][c] * sm.kd[s][c];
          b += sm.d_o[t][c] * sm.v[s][c];
        }
      } else if (s == t) {
#pragma unroll 8
        for (int c = 0; c < K; ++c) {
          a += sm.r[t][c] * sm.us[c] * sm.k[t][c];
          b += sm.d_o[t][c] * sm.v[t][c];
        }
        sm.dd[t] = a;
        sm.dg[t] = b;
        a = b = 0.f;
      }
      sm.p[t][s] = a;
      sm.dp[t][s] = b;
    }
    __syncthreads();

    // 4. dqd, dkd, dkw into shared memory; dv out
    for (int i = tid; i < CK; i += NT) {
      const int t = i / K, c = i % K;
      float q = 0.f, kk = 0.f, w = 0.f, dvv = 0.f;
#pragma unroll 8
      for (int j = 0; j < V; ++j) {
        q += sm.s0[c][j] * sm.d_o[t][j];
        w += sm.ds[c][j] * sm.v[t][j];
        dvv += sm.kw[t][j] * sm.ds[j][c];   // j: a key channel, c: value
      }
      for (int s = 0; s < t; ++s) q += sm.dp[t][s] * sm.kd[s][c];
      for (int t2 = t + 1; t2 < kSub; ++t2) {
        kk += sm.dp[t2][t] * sm.qd[t2][c];
        dvv += sm.p[t2][t] * sm.d_o[t2][c];
      }
      dvv += sm.dd[t] * sm.d_o[t][c];
      sm.dqd[t][c] = q;
      sm.dkd[t][c] = kk;
      sm.dkw[t][c] = w;
      if (t0 + t < S)
        dv[base + static_cast<long long>(t0 + t) * step + c] =
            from_f32<T>(dvv);
    }
    __syncthreads();

    // 5. dr, dk out; a + b (into dkd) and b (into dqd) for dlogw
    for (int i = tid; i < CK; i += NT) {
      const int t = i / K, c = i % K;
      const float cu = sm.cum[t][c], ex = cu - sm.lw[t][c];
      const float dq = sm.dqd[t][c], dkd = sm.dkd[t][c], dkw = sm.dkw[t][c];
      const float g = sm.dg[t] * sm.us[c];
      if (t0 + t < S) {
        const long long off = base + static_cast<long long>(t0 + t) * step
                              + c;
        dr[off] = from_f32<T>(dq * expf(ex) + g * sm.k[t][c]);
        dk[off] = from_f32<T>(dkd * expf(-cu) + dkw * expf(sm.tot[c] - cu)
                              + g * sm.r[t][c]);
      }
      const float b = dq * sm.qd[t][c];
      sm.dkd[t][c] = b - dkd * sm.kd[t][c] - dkw * sm.kw[t][c];
      sm.dqd[t][c] = b;
    }
    __syncthreads();

    // 6. dlogw (a reverse sum over the steps) and du, one channel a thread
    if (tid < K) {
      const int c = tid;
      float dtot = 0.f, sd = 0.f;
      for (int j = 0; j < V; ++j) sd += sm.s0[c][j] * sm.ds[c][j];
      for (int t = 0; t < kSub; ++t) {
        dtot += sm.dkw[t][c] * sm.kw[t][c];
        du_acc += sm.r[t][c] * sm.k[t][c] * sm.dg[t];
      }
      dtot += sm.wt[c] * sd;
      float acc = 0.f;
      for (int t = kSub - 1; t >= 0; --t) {
        acc += sm.dkd[t][c];
        if (t0 + t < S)
          dlogw[base + static_cast<long long>(t0 + t) * step + c] =
              acc - sm.dqd[t][c] + dtot;
      }
    }
    __syncthreads();

    // 7. dS <- e^{tot} dS + sum_t qd_t do_t^T
    for (int i = tid; i < K * V; i += NT) {
      const int c = i / V, j = i % V;
      float acc = sm.wt[c] * sm.ds[c][j];
#pragma unroll
      for (int t = 0; t < kSub; ++t) acc += sm.qd[t][c] * sm.d_o[t][j];
      sm.ds[c][j] = acc;
    }
    __syncthreads();
  }

  if (tid < K) du_rows[bh * K + tid] = du_acc;
  if (dstate_in)
    for (int i = tid; i < K * V; i += NT)
      dstate_in[bh * K * V + i] = sm.ds[i / V][i % V];
}

// du (G, H, K) in T = the sum, in row order, of du_rows over the u_div
// rows that share each u row. One thread per (g, h, c).
template <typename T>
__global__ void rwkv6_du_kernel(const float* __restrict__ du_rows,
                                T* __restrict__ du, long long G,
                                long long HK, long long u_div) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= G * HK) return;
  const long long g = i / HK, e = i % HK;
  float acc = 0.f;
  for (long long m = 0; m < u_div; ++m)
    acc += du_rows[(g * u_div + m) * HK + e];
  du[i] = from_f32<T>(acc);
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* states,
                   const void* d_o, const void* dstate_out, void* dr,
                   void* dk, void* dv, void* dlogw, void* du,
                   void* du_rows, void* dstate_in, long long N, int S,
                   int H, long long G, cudaStream_t stream) {
  constexpr int bytes = sizeof(Smem<K>);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const long long u_div = N / G;
  rwkv6_bwd_kernel<T, K><<<static_cast<unsigned>(N * H), 4 * K, bytes,
                           stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const T*>(u), static_cast<const float*>(states),
      static_cast<const T*>(d_o), static_cast<const float*>(dstate_out),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dlogw), static_cast<float*>(du_rows),
      static_cast<float*>(dstate_in), S, H, u_div);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long HK = static_cast<long long>(H) * K;
  const long long total = G * HK;
  rwkv6_du_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       stream>>>(static_cast<const float*>(du_rows),
                                 static_cast<T*>(du), G, HK, u_div);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(int dtype, const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* states,
                     const void* d_o, const void* dstate_out, void* dr,
                     void* dk, void* dv, void* dlogw, void* du,
                     void* du_rows, void* dstate_in, long long N, int S,
                     int H, long long G, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, K>(r, k, v, logw, u, states, d_o, dstate_out, dr,
                            dk, dv, dlogw, du, du_rows, dstate_in, N, S, H,
                            G, stream);
  return launch<__nv_bfloat16, K>(r, k, v, logw, u, states, d_o, dstate_out,
                                  dr, dk, dv, dlogw, du, du_rows, dstate_in,
                                  N, S, H, G, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 for r, k, v, u, do, dr, dk, dv, du. r, k, v,
// logw, do, dr, dk, dv, dlogw: (N, S, H, K) contiguous; u, du: (G, H, K)
// with G dividing N; states: (N, H, ceil(S / 16), K, K) f32 from the
// forward kernel; dstate_out: (N, H, K, K) f32 or null (zeros); du_rows:
// (N, H, K) f32 scratch; dstate_in: (N, H, K, K) f32 or null (not
// written). K = V in {16, 32, 64}. Two launches (the sweep, then the du
// sum); returns the first cudaError_t (0 on success); nothing is
// synchronized and nothing allocated.
int repro_rwkv6_backward(int dtype, int K, const void* r, const void* k,
                         const void* v, const void* logw, const void* u,
                         const void* states, const void* d_o,
                         const void* dstate_out, void* dr, void* dk,
                         void* dv, void* dlogw, void* du, void* du_rows,
                         void* dstate_in, long long N, int S, int H,
                         long long G, void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 || G <= 0 || N % G ||
      N * H > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16:
      return launch_k<16>(dtype, r, k, v, logw, u, states, d_o, dstate_out,
                          dr, dk, dv, dlogw, du, du_rows, dstate_in, N, S,
                          H, G, s);
    case 32:
      return launch_k<32>(dtype, r, k, v, logw, u, states, d_o, dstate_out,
                          dr, dk, dv, dlogw, du, du_rows, dstate_in, N, S,
                          H, G, s);
    case 64:
      return launch_k<64>(dtype, r, k, v, logw, u, states, d_o, dstate_out,
                          dr, dk, dv, dlogw, du, du_rows, dstate_in, N, S,
                          H, G, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_rwkv6_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
