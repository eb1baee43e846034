// Flash attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by repro_torch/kernels/attention/flash_bwd.py).
//
// The JAX package has no Pallas backward: its train step differentiates the
// jnp `chunked_attention` (src/repro/models/layers.py). This kernel is the
// backward of the port's forward kernel (csrc/flash.cu, which replaces the
// Pallas `_flash_kernel`): from q, k, v, the forward's output o, its row
// statistics m and l (f32, (B, H, Sq)) and the output's cotangent do, it
// writes dq, dk and dv under the forward's masks (int32 positions, causal,
// window; NEG_INF = -1e30). p = exp(s - m) / max(l, 1e-30) as the forward
// normalizes; a row that sees no key has m = -1e30 and l = Sk, so its p is
// 1 / Sk over every key: dv gets do / Sk from it, dq and dk nothing (a
// masked score is a constant). D = rowsum(do * o) in f32.
//
// Deterministic: no float atomics. Two kernels, each output written by one
// CTA that sums in a fixed order:
//   (a) dq: one CTA per (batch, kv head, 64 query rows), a loop over key
//       tiles of 64: S = q k^T, dP = do v^T, dS = p (dP - D), dq += dS k.
//       It also writes D for the rows, which (b) reads after it on the
//       same stream.
//   (b) dk / dv: one CTA per (batch, kv head, 64 keys), a loop over the
//       G * Sq query rows of the kv head in tiles of 64: dv += p^T do,
//       dk += dS^T q. The GQA sum over the group runs inside the loop.
// A (row tile, key tile) pair is skipped when the tiles' position bounds
// show no visible pair; (b) keeps a pair whose rows include one that sees
// no key (its dv term covers every key).
//
// Bound: operations. 10 * hd FLOPs per visible (query head, key) pair
// (4 * hd of the forward recomputed, 6 * hd of the three products), about
// 2.5x the forward's. This first kernel runs every product on CUDA cores in
// f32 (bf16 inputs are widened as they are loaded): 256 threads, each
// holding a 4 x 4 block of the 64 x 64 score tile and a 4 x 8 block of its
// 64 x 128 output tile, with the tiles in f32 shared memory padded so that
// no access conflicts on a bank. Tensor cores (mma.sync / wgmma) are left
// for later. Head dim 128 only (qwen3's); the wrapper raises on others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kHD = 128;
constexpr int kTile = 64;          // rows of a query tile, keys of a key tile
constexpr int kThreads = 256;      // 16 x 16: thread (a, b)
constexpr int kLD = kHD + 1;       // f32 pitch of a 64 x 128 tile
constexpr int kLDS = kTile + 16;   // f32 pitch of a 64 x 64 tile
constexpr int kDims = kHD / 16;    // output dims a thread holds (b + 16 j)

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// whether some (query, key) pair of the two tiles' position ranges may be
// visible (conservative: true when unsure)
__device__ __forceinline__ bool may_see(int qmin, int qmax, int kmin,
                                        int kmax, int causal, int window) {
  if (kmax < 0) return false;
  if (causal && kmin > qmax) return false;
  if (window > 0 && qmin - kmax >= window) return false;
  return true;
}

struct Shape {
  int Sq, Sk, H, KV, causal, window;
  float scale;
};

// Row r of kv head kvh (r < G * Sq): position r / G of query head
// kvh * G + r % G. Offsets of its q / o / do row and of its stats.
__device__ __forceinline__ size_t qrow(const Shape& s, int b, int kvh, int r) {
  const int G = s.H / s.KV;
  return ((size_t)(b * s.Sq + r / G) * s.H + kvh * G + r % G) * kHD;
}
__device__ __forceinline__ size_t stat_row(const Shape& s, int b, int kvh,
                                           int r) {
  const int G = s.H / s.KV;
  return (size_t)(b * s.H + kvh * G + r % G) * s.Sq + r / G;
}

// (a) dq and D. grid = (B * KV, ceil(G * Sq / 64)), block 256.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, T* __restrict__ dq,
                    float* __restrict__ delta, Shape s) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                       // [64][kLD], q * scale
  float* dOs = Qs + kTile * kLD;        // [64][kLD]
  float* Ks = dOs + kTile * kLD;        // [64][kLD]
  float* Vs = Ks + kTile * kLD;         // [64][kLD]
  float* dSs = Vs + kTile * kLD;        // [64][kLDS]
  float* mr = dSs + kTile * kLDS;       // [64] row max
  float* li = mr + kTile;               // [64] 1 / max(l, 1e-30)
  float* Dr = li + kTile;               // [64] rowsum(do * o)
  int* qp = reinterpret_cast<int*>(Dr + kTile);  // [64]
  int* kp = qp + kTile;                           // [64]
  __shared__ int bounds[4];             // qmin, qmax, kmin, kmax

  const int G = s.H / s.KV, R = s.Sq * G;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int row0 = blockIdx.y * kTile;
  const int t = threadIdx.x, ta = t / 16, tb = t % 16;
  const int warp = t / 32, lane = t % 32;

  if (t == 0) {
    bounds[0] = 0x7fffffff;
    bounds[1] = -0x7fffffff - 1;
  }
  for (int e = t; e < kTile * kHD; e += kThreads) {
    const int rr = e / kHD, d = e % kHD, r = row0 + rr;
    float qv = 0.f, dv = 0.f;
    if (r < R) {
      const size_t off = qrow(s, b, kvh, r) + d;
      qv = load(q + off) * s.scale;
      dv = load(dout + off);
    }
    Qs[rr * kLD + d] = qv;
    dOs[rr * kLD + d] = dv;
  }
  __syncthreads();
  if (t < kTile) {
    const int r = row0 + t;
    const bool ok = r < R;
    qp[t] = ok ? q_pos[(size_t)b * s.Sq + r / G] : 0;
    mr[t] = ok ? m_in[stat_row(s, b, kvh, r)] : 0.f;
    li[t] = ok ? 1.f / fmaxf(l_in[stat_row(s, b, kvh, r)], 1e-30f) : 0.f;
    if (ok) {
      atomicMin(&bounds[0], qp[t]);
      atomicMax(&bounds[1], qp[t]);
    }
  }
  // D: warp w sums rows 8w .. 8w + 7, lane over the head dim
  for (int i = 0; i < kTile / 8; ++i) {
    const int rr = warp * (kTile / 8) + i, r = row0 + rr;
    float acc = 0.f;
    if (r < R) {
      const size_t off = qrow(s, b, kvh, r);
      for (int d = lane; d < kHD; d += 32)
        acc = fmaf(dOs[rr * kLD + d], load(o + off + d), acc);
    }
    for (int w = 16; w > 0; w >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) {
      Dr[rr] = acc;
      if (r < R) delta[stat_row(s, b, kvh, r)] = acc;
    }
  }
  __syncthreads();
  const int qmin = bounds[0], qmax = bounds[1];

  float acc[4][kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;

  const size_t kv_row = (size_t)s.KV * kHD;
  const T* kb = k + ((size_t)b * s.Sk * s.KV + kvh) * kHD;
  const T* vb = v + ((size_t)b * s.Sk * s.KV + kvh) * kHD;
  for (int k0 = 0; k0 < s.Sk; k0 += kTile) {
    __syncthreads();   // the previous tile is consumed
    if (t == 0) {
      bounds[2] = 0x7fffffff;
      bounds[3] = -0x7fffffff - 1;
    }
    __syncthreads();
    if (t < kTile) {
      const int c = k0 + t;
      kp[t] = c < s.Sk ? k_pos[(size_t)b * s.Sk + c] : 0;
      if (c < s.Sk) {
        atomicMin(&bounds[2], kp[t]);
        atomicMax(&bounds[3], kp[t]);
      }
    }
    __syncthreads();
    if (!may_see(qmin, qmax, bounds[2], bounds[3], s.causal, s.window))
      continue;
    for (int e = t; e < kTile * kHD; e += kThreads) {
      const int j = e / kHD, d = e % kHD, c = k0 + j;
      const bool ok = c < s.Sk;
      Ks[j * kLD + d] = ok ? load(kb + (size_t)c * kv_row + d) : 0.f;
      Vs[j * kLD + d] = ok ? load(vb + (size_t)c * kv_row + d) : 0.f;
    }
    __syncthreads();
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHD; ++d) {
      float qa[4], da[4], kb4[4], vb4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ta + 16 * i) * kLD + d];
        da[i] = dOs[(ta + 16 * i) * kLD + d];
        kb4[i] = Ks[(tb + 16 * i) * kLD + d];
        vb4[i] = Vs[(tb + 16 * i) * kLD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i], kb4[j], sc[i][j]);
          dp[i][j] = fmaf(da[i], vb4[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ta + 16 * i;
      const bool row_ok = row0 + rr < R;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tb + 16 * j;
        const bool vis = row_ok && k0 + cc < s.Sk &&
                         visible(qp[rr], kp[cc], s.causal, s.window);
        const float p = vis ? expf(sc[i][j] - mr[rr]) * li[rr] : 0.f;
        dSs[rr * kLDS + cc] = vis ? p * (dp[i][j] - Dr[rr]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kc[kDims];
#pragma unroll
      for (int j = 0; j < kDims; ++j) kc[j] = Ks[c * kLD + tb + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ta + 16 * i) * kLDS + c];
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[i][j] = fmaf(ds, kc[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ta + 16 * i;
    if (r >= R) continue;
    const size_t off = qrow(s, b, kvh, r);
#pragma unroll
    for (int j = 0; j < kDims; ++j)
      store(dq + off + tb + 16 * j, acc[i][j] * s.scale);
  }
}

// (b) dk and dv. grid = (B * KV, ceil(Sk / 64)), block 256.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ m_in,
                      const float* __restrict__ l_in,
                      const float* __restrict__ delta,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ k_pos, T* __restrict__ dk,
                      T* __restrict__ dv, Shape s) {
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                       // [64][kLD]
  float* Vs = Ks + kTile * kLD;         // [64][kLD]
  float* Qs = Vs + kTile * kLD;         // [64][kLD], q * scale
  float* dOs = Qs + kTile * kLD;        // [64][kLD]
  float* Ps = dOs + kTile * kLD;        // [64 rows][kLDS]
  float* dSs = Ps + kTile * kLDS;       // [64 rows][kLDS]
  float* mr = dSs + kTile * kLDS;       // [64]
  float* li = mr + kTile;               // [64]
  float* Dr = li + kTile;               // [64]
  int* qp = reinterpret_cast<int*>(Dr + kTile);  // [64]
  int* kp = qp + kTile;                           // [64]
  __shared__ int bounds[4];             // kmin, kmax, qmin, qmax

  const int G = s.H / s.KV, R = s.Sq * G;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int k0 = blockIdx.y * kTile;
  const int t = threadIdx.x, ta = t / 16, tb = t % 16;

  const size_t kv_row = (size_t)s.KV * kHD;
  const T* kb = k + ((size_t)b * s.Sk * s.KV + kvh) * kHD;
  const T* vb = v + ((size_t)b * s.Sk * s.KV + kvh) * kHD;
  if (t == 0) {
    bounds[0] = 0x7fffffff;
    bounds[1] = -0x7fffffff - 1;
  }
  for (int e = t; e < kTile * kHD; e += kThreads) {
    const int j = e / kHD, d = e % kHD, c = k0 + j;
    const bool ok = c < s.Sk;
    Ks[j * kLD + d] = ok ? load(kb + (size_t)c * kv_row + d) : 0.f;
    Vs[j * kLD + d] = ok ? load(vb + (size_t)c * kv_row + d) : 0.f;
  }
  __syncthreads();
  if (t < kTile) {
    const int c = k0 + t;
    kp[t] = c < s.Sk ? k_pos[(size_t)b * s.Sk + c] : 0;
    if (c < s.Sk) {
      atomicMin(&bounds[0], kp[t]);
      atomicMax(&bounds[1], kp[t]);
    }
  }
  __syncthreads();
  const int kmin = bounds[0], kmax = bounds[1];

  // thread (ta, tb) holds keys ta + 16 i and dims tb + 16 j
  float gk[4][kDims], gv[4][kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDims; ++j) gk[i][j] = gv[i][j] = 0.f;

  for (int row0 = 0; row0 < R; row0 += kTile) {
    __syncthreads();   // the previous row tile is consumed
    if (t == 0) {
      bounds[2] = 0x7fffffff;
      bounds[3] = -0x7fffffff - 1;
    }
    __syncthreads();
    bool dead = false;
    if (t < kTile) {
      const int r = row0 + t;
      const bool ok = r < R;
      qp[t] = ok ? q_pos[(size_t)b * s.Sq + r / G] : 0;
      mr[t] = ok ? m_in[stat_row(s, b, kvh, r)] : 0.f;
      li[t] = ok ? 1.f / fmaxf(l_in[stat_row(s, b, kvh, r)], 1e-30f) : 0.f;
      Dr[t] = ok ? delta[stat_row(s, b, kvh, r)] : 0.f;
      dead = ok && mr[t] <= 0.5f * kNegInf;   // sees no key: m = -1e30
      if (ok) {
        atomicMin(&bounds[2], qp[t]);
        atomicMax(&bounds[3], qp[t]);
      }
    }
    dead = __syncthreads_or(dead);
    if (!dead &&
        !may_see(bounds[2], bounds[3], kmin, kmax, s.causal, s.window))
      continue;
    for (int e = t; e < kTile * kHD; e += kThreads) {
      const int rr = e / kHD, d = e % kHD, r = row0 + rr;
      float qv = 0.f, dv2 = 0.f;
      if (r < R) {
        const size_t off = qrow(s, b, kvh, r) + d;
        qv = load(q + off) * s.scale;
        dv2 = load(dout + off);
      }
      Qs[rr * kLD + d] = qv;
      dOs[rr * kLD + d] = dv2;
    }
    __syncthreads();
    // thread (ta, tb) scores rows ta + 16 i against keys tb + 16 j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHD; ++d) {
      float qa[4], da[4], kb4[4], vb4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ta + 16 * i) * kLD + d];
        da[i] = dOs[(ta + 16 * i) * kLD + d];
        kb4[i] = Ks[(tb + 16 * i) * kLD + d];
        vb4[i] = Vs[(tb + 16 * i) * kLD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i], kb4[j], sc[i][j]);
          dp[i][j] = fmaf(da[i], vb4[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ta + 16 * i;
      const bool row_ok = row0 + rr < R;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tb + 16 * j;
        const bool key_ok = row_ok && k0 + cc < s.Sk;
        const bool vis =
            key_ok && visible(qp[rr], kp[cc], s.causal, s.window);
        // a masked score is -1e30: p = 0, or 1 / Sk on a row that sees
        // no key (m = -1e30)
        const float p =
            key_ok ? expf((vis ? sc[i][j] : kNegInf) - mr[rr]) * li[rr] : 0.f;
        Ps[rr * kLDS + cc] = p;
        dSs[rr * kLDS + cc] = vis ? p * (dp[i][j] - Dr[rr]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float dor[kDims], qr[kDims];
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        dor[j] = dOs[r * kLD + tb + 16 * j];
        qr[j] = Qs[r * kLD + tb + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[r * kLDS + ta + 16 * i];
        const float ds = dSs[r * kLDS + ta + 16 * i];
#pragma unroll
        for (int j = 0; j < kDims; ++j) {
          gv[i][j] = fmaf(p, dor[j], gv[i][j]);
          gk[i][j] = fmaf(ds, qr[j], gk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ta + 16 * i;
    if (c >= s.Sk) continue;
    const size_t off = ((size_t)(b * s.Sk + c) * s.KV + kvh) * kHD;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      store(dk + off + tb + 16 * j, gk[i][j]);
      store(dv + off + tb + 16 * j, gv[i][j]);
    }
  }
}

constexpr int dq_smem_bytes() {
  return (4 * kTile * kLD + kTile * kLDS + 3 * kTile) * 4 + 2 * kTile * 4;
}
constexpr int dkdv_smem_bytes() {
  return (4 * kTile * kLD + 2 * kTile * kLDS + 3 * kTile) * 4 + 2 * kTile * 4;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* m, const float* l,
                   const int* qp, const int* kp, void* dq, void* dk, void* dv,
                   float* delta, int B, const Shape& s, cudaStream_t st) {
  const int R = s.Sq * (s.H / s.KV);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem_bytes());
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dkdv_smem_bytes());
  if (e != cudaSuccess) return e;
  const dim3 g1(B * s.KV, (R + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T><<<g1, kThreads, dq_smem_bytes(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), m, l, qp, kp, static_cast<T*>(dq), delta,
      s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 g2(B * s.KV, (s.Sk + kTile - 1) / kTile);
  flash_bwd_dkdv_kernel<T><<<g2, kThreads, dkdv_smem_bytes(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), m, l, delta, qp,
      kp, static_cast<T*>(dk), static_cast<T*>(dv), s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv share it).
// q, o, do, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Sk, KV, hd); m, l, delta:
// f32 (B, H, Sq) (delta is scratch that this call writes); positions int32
// (B, Sq) / (B, Sk). hd must be 128. Two launches on `stream`; returns the
// first cudaError_t that is not cudaSuccess, or 0. Nothing is synchronized
// and nothing is allocated.
int repro_flash_attention_backward(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* m,
                                   const void* l, const void* q_pos,
                                   const void* k_pos, void* dq, void* dk,
                                   void* dv, void* delta, int B, int Sq,
                                   int Sk, int H, int KV, int hd, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || hd != kHD ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if ((Sq * (H / KV) + kTile - 1) / kTile > 65535 ||
      (Sk + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  const Shape s{Sq, Sk, H, KV, causal, window, scale};
  const float* mm = static_cast<const float*>(m);
  const float* ll = static_cast<const float*>(l);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(q, k, v, o, dout, mm, ll, qp, kp, dq, dk, dv, dl,
                             B, s, st)
             : launch<__nv_bfloat16>(q, k, v, o, dout, mm, ll, qp, kp, dq, dk,
                                     dv, dl, B, s, st);
}

const char* repro_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
