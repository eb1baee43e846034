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
// a CTA owns one (batch, head) and loops over the sequence in sub-chunks of
// kSub = 16 steps whatever the caller's chunk (the function is the
// recurrence, so the sub-chunk is the kernel's own choice). Inside a
// sub-chunk the products are taken relative to its start, as the reference
// does (k_s e^{-cum_s} against r_t e^{cum_{t-1}}); 16 steps keep e^{-cum}
// far from f32's limit under the JAX sweep's strong decay, where 32 need
// not. Per sub-chunk: A (16 x 16: decayed scores below the diagonal, the
// bonus r.(u*k) on it), o = (decayed r) S + A v, S <- e^{tot} S +
// (weighted k)^T v.
//
// One form for both input types (rwkv6_kernel<T, K>, K / 16 warps). The
// state stays in registers for the whole sequence; the next sub-chunk's
// inputs are loaded into registers (16-byte f32 / 8-byte bf16 vectors) a
// sub-chunk ahead and turned into the next sub-chunk's shared tiles while
// the current ones feed the products: the inclusive cumsum of logw as a
// shuffle scan over the 16 steps (lanes 2t and 2t + 1 hold step t of an
// 8-channel block), with the decays r e^{cum - logw}, k e^{-cum},
// k e^{tot - cum}, e^{tot} and r u k folded into the same pass. One barrier
// a sub-chunk.
//
// The products run on tensor cores: mma.sync m16n8k16 with f32
// accumulators. Warp w holds S^T rows [16 w, 16 w + 16) (state columns) as
// K / 8 accumulator tiles, whose layout is the A fragment of o^T = S^T
// qd^T; qd's fragments serve as A of the scores and B of o; every warp
// computes A itself. To keep f32 arithmetic, each f32 operand (qd, kd, kw,
// S, A, and v when it comes in f32) is split into three bf16 pieces (24
// mantissa bits) and each product takes the piece products above f32's
// last bit (mma_split); a bf16 v is exact in one piece. Over chip_smoke.py's
// RWKV6 cases the final state then stays within 1.5e-6 of max(1, max|S|)
// of the f64 recurrence; two pieces read 4.4e-6 (bf16) and 1.4e-5 (f32),
// one piece 2.3e-3 / 4.1e-3 (tools/rwkv6_pieces.py). The kernel phase
// gates it at 2.5e-6.
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py):
// latency. Each sub-chunk is a chain of dependent mma (the scores, then A
// v, the state after), and two CTAs of 4 warps an SM hide little of it;
// fewer pieces run faster in proportion (tools/rwkv6_pieces.py: 0.0129 /
// 0.0098 / 0.0082 ms at (4, 48, 64, 64) bf16 with 3 / 2 / 1 pieces). At
// the serving shapes (32 or 48 steps, B * H = 256 CTAs) the 2-3 sub-chunks
// take 0.0094 / 0.0129 ms, 3.0-3.2x the bytes bound; at (4, 512, 64, 64)
// 0.106 ms in bf16 (3.2x the bytes bound) and 0.107 in f32 (1.7x the FP32
// operations bound; the FP32 FMA form took 0.170, bound by shared-memory
// reads).
//
// For training the kernel also writes, when asked (states non-null), the f32
// state at the start of every fourth sub-chunk (every kSave = 64 steps),
// (N, H, ceil(S / 64), K, K): what the backward kernel (rwkv6_bwd.cu)
// rebuilds each 64-step chunk from. The write sits outside the
// arithmetic, so a launch without it returns the same bits.
//
// Build (nvcc -O3, sm_90a): 204 / 172 / 128 registers a thread at K = 64 /
// 32 / 16 in bf16, 150 / 192 / 148 in f32, no spill; cuobjdump -sass shows
// HMMA (126 / 66 / 36 in bf16, 156 / 84 / 48 in f32), FFMA 272 (the decays
// and the splits) and no HGMMA. Times: PERF.md section 6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSub = 16;          // steps per sub-chunk
constexpr int kSave = 64;         // steps between saved states
constexpr int kPer = kSave / kSub;
constexpr unsigned kFull = 0xffffffffu;

// Four consecutive elements of an input, as loaded (raw) and in f32; one
// element in f32 (one) and from f32 (out).
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  using raw = float4;
  __device__ __forceinline__ static raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static float4 f32(raw x) { return x; }
  __device__ __forceinline__ static float one(float x) { return x; }
  __device__ __forceinline__ static float out(float x) { return x; }
};

template <>
struct Quad<__nv_bfloat16> {
  using raw = uint2;
  __device__ __forceinline__ static raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ static raw zero() { return make_uint2(0, 0); }
  __device__ __forceinline__ static float4 f32(raw x) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ __forceinline__ static float one(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 out(float x) {
    return __float2bfloat16(x);
  }
};

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}
// c += a b for a 16 x 16 bf16 A fragment and a 16 x 8 B fragment (b0, b1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// An f32 operand as kPieces bf16 values, each the bf16 rounding of what
// the ones before leave: their sum keeps 24 bits of the mantissa, so the
// products below round as f32 FMA does, not as bf16.
constexpr int kPieces = 3;

// (x0, x1) as NP bf16 pairs (NP = 1: a bf16 input, exact in one)
template <int NP>
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&out)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    out[p] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// c += sum over the pieces a_i b_j with i + j < kPieces, smallest first:
// the f32 product a b to within f32 rounding. A has NA pieces (1 when it
// is exact in bf16), B kPieces.
template <int NA>
__device__ __forceinline__ void mma_split(
    float (&c)[4], const uint32_t (&a)[NA][4],
    const uint32_t (&b0)[kPieces], const uint32_t (&b1)[kPieces]) {
#pragma unroll
  for (int d = kPieces - 1; d >= 0; --d)
#pragma unroll
    for (int i = 0; i <= d && i < NA; ++i)
      mma_bf16(c, a[i], b0[d - i], b1[d - i]);
}

// v's bf16 pieces: one for a bf16 input, kPieces for f32
template <typename T>
constexpr int kVPieces = std::is_same<T, float>::value ? kPieces : 1;

// One sub-chunk's operands in shared memory, in bf16 pieces. Rows are
// padded by 8 elements: ldmatrix and the tile stores are conflict-free.
template <int K, int VP>
struct Tiles {
  static constexpr int KP = K + 8;
  __nv_bfloat16 qd[kPieces][kSub][KP];   // r_t e^{cum_{t-1}}
  __nv_bfloat16 kd[kPieces][kSub][KP];   // k_s e^{-cum_s}
  __nv_bfloat16 kw[kPieces][kSub][KP];   // k_s e^{tot - cum_s}
  __nv_bfloat16 vs[VP][kSub][KP];        // v_s
  float wt[K];                           // e^{tot}
  float dp[kSub][K / 8];                 // r_t u k_t, summed over each block
};

// r, k, v, logw, o: (N, S, H, K) (V == K), r, k, v, u, o in T; u: (G, H,
// K), batch row n reads u row n / u_div; state_in (may be null),
// state_out: (N, H, K, K); states (may be null): (N, H, ceil(S / kSub),
// K, K), the state at every fourth sub-chunk's start. grid = N * H CTAs,
// one per
// (batch, head);
// block = 2 K threads (K / 16 warps); two Tiles of dynamic shared memory.
template <typename T, int K>
__global__ void __launch_bounds__(2 * K, 2)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ logw,
             const T* __restrict__ u, const float* __restrict__ state_in,
             T* __restrict__ o, float* __restrict__ state_out,
             float* __restrict__ states, int S, int H, long long u_div) {
  using bf16 = __nv_bfloat16;
  using Q = Quad<T>;
  constexpr int V = K;
  constexpr int NT = 2 * K;
  constexpr int NW = K / 16;        // warps: 16 state columns each
  constexpr int KB = K / 8;         // 8-channel blocks of a step
  constexpr int MB = KB / NW;       // blocks a warp makes (2)
  constexpr int NS = K / 16;        // k-steps over the channels
  constexpr int VP = kVPieces<T>;
  constexpr int KP = Tiles<K, VP>::KP;

  extern __shared__ __align__(16) unsigned char smem[];
  Tiles<K, VP>* tiles = reinterpret_cast<Tiles<K, VP>*>(smem);
  __shared__ float us[K];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;  // fragment row / column pair
  const long long bh = blockIdx.x;
  const long long n = bh / H;
  const int h = static_cast<int>(bh % H);
  const long long step = static_cast<long long>(H) * K;
  const long long base = n * S * step + static_cast<long long>(h) * K;
  // tile layout: step pt of channels [c, c + 4) of each block a warp makes
  const int pt = lane >> 1, pq = 4 * (lane & 1);

  for (int i = tid; i < K; i += NT)
    us[i] = Q::one(u[(n / u_div) * step + static_cast<long long>(h) * K + i]);

  // st[nt]: S^T rows j = 16 w + g (+ 8 for [2], [3]), columns c = 8 nt + 2 q
  // (+ 1 for [1], [3])
  float st[K / 8][4];
#pragma unroll
  for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * w + g + 8 * (e >> 1), c = 8 * nt + 2 * q + (e & 1);
      st[nt][e] = state_in ? state_in[(bh * K + c) * V + j] : 0.f;
    }

  // the next sub-chunk's inputs, in registers
  typename Q::raw rq[MB], kq[MB], vq[MB];
  float4 lq[MB];
  auto fetch = [&](int t0) {
    const bool in = t0 + pt < S;
    const long long row = base + static_cast<long long>(t0 + pt) * step;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const long long off = row + 8 * (w + NW * m) + pq;
      rq[m] = in ? Q::load(r + off) : Q::zero();
      kq[m] = in ? Q::load(k + off) : Q::zero();
      vq[m] = in ? Q::load(v + off) : Q::zero();
      lq[m] = in ? *reinterpret_cast<const float4*>(logw + off)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  // registers -> tiles[b]: cumsum of logw over the 16 steps (lanes 2t and
  // 2t + 1 hold step t of a block), the decays, the pieces
  auto make_tiles = [&](int b) {
    Tiles<K, VP>& tb = tiles[b];
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const int blk = w + NW * m, c = 8 * blk + pq;
      const float4 r4 = Q::f32(rq[m]), k4 = Q::f32(kq[m]);
      const float4 v4 = Q::f32(vq[m]);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float lw[4] = {lq[m].x, lq[m].y, lq[m].z, lq[m].w};
      float cum[4] = {lw[0], lw[1], lw[2], lw[3]};
#pragma unroll
      for (int d = 1; d < kSub; d *= 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = __shfl_up_sync(kFull, cum[e], 2 * d);
          if (pt >= d) cum[e] += y;
        }
      }
      float qd[4], kd[4], kw[4], tot[4], ruk = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[e] = __shfl_sync(kFull, cum[e], 30 + (lane & 1));
        qd[e] = rr[e] * expf(cum[e] - lw[e]);
        kd[e] = kk[e] * expf(-cum[e]);
        kw[e] = kk[e] * expf(tot[e] - cum[e]);
        ruk += rr[e] * us[c + e] * kk[e];
      }
      ruk += __shfl_xor_sync(kFull, ruk, 1);
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        const float* x = y == 0 ? qd : y == 1 ? kd : kw;
        bf16(*tile)[kSub][KP] = y == 0 ? tb.qd : y == 1 ? tb.kd : tb.kw;
        uint32_t x01[kPieces], x23[kPieces];
        split_bf16(x[0], x[1], x01);
        split_bf16(x[2], x[3], x23);
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
          *reinterpret_cast<uint2*>(&tile[p][pt][c]) =
              make_uint2(x01[p], x23[p]);
      }
      uint32_t v01[VP], v23[VP];
      split_bf16(v4.x, v4.y, v01);
      split_bf16(v4.z, v4.w, v23);
#pragma unroll
      for (int p = 0; p < VP; ++p)
        *reinterpret_cast<uint2*>(&tb.vs[p][pt][c]) =
            make_uint2(v01[p], v23[p]);
      if ((lane & 1) == 0) tb.dp[pt][blk] = ruk;
      if (pt == kSub - 1)
        store4(&tb.wt[c], make_float4(expf(tot[0]), expf(tot[1]),
                                      expf(tot[2]), expf(tot[3])));
    }
  };

  // sub-chunk t0 from tiles[b]: A, o, then the state update, each product
  // of split operands by mma_split
  auto products = [&](int b, int t0) {
    const Tiles<K, VP>& tb = tiles[b];
    // per k-step (16 channels): the qd fragments are A of the scores (rows
    // t, columns c) and, read as B (k = c, n = t), of o^T = S^T qd^T; the
    // scores sc[nt] (rows t = g (+ 8), columns s = 8 nt + 2 q (+ 1)) and
    // o^T's S^T qd^T part oa[nt] (rows j, columns t = 8 nt + 2 q (+ 1))
    // build up together
    float sc[2][4] = {}, oa[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t qf[kPieces][4], kf[kPieces][4], sa[kPieces][4];
#pragma unroll
      for (int x = 0; x < kPieces; ++x) {
        ldsm_x4(qf[x], &tb.qd[x][(lane & 7) + 8 * ((lane >> 3) & 1)]
                               [16 * kk + 8 * (lane >> 4)]);
        ldsm_x4(kf[x], &tb.kd[x][(lane & 7) + 8 * (lane >> 4)]
                               [16 * kk + 8 * ((lane >> 3) & 1)]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b0[kPieces], b1[kPieces];
#pragma unroll
        for (int x = 0; x < kPieces; ++x) {
          b0[x] = kf[x][2 * nt];
          b1[x] = kf[x][2 * nt + 1];
        }
        mma_split(sc[nt], qf, b0, b1);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {   // S^T's A fragment
        const float* x = st[2 * kk + (a >> 1)] + 2 * (a & 1);
        uint32_t pieces[kPieces];
        split_bf16(x[0], x[1], pieces);
#pragma unroll
        for (int p = 0; p < kPieces; ++p) sa[p][a] = pieces[p];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b0[kPieces], b1[kPieces];
#pragma unroll
        for (int x = 0; x < kPieces; ++x) {
          b0[x] = qf[x][nt];
          b1[x] = qf[x][nt + 2];
        }
        mma_split(oa[nt], sa, b0, b1);
      }
    }
    float diag[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < KB; ++x) {
      diag[0] += tb.dp[g][x];
      diag[1] += tb.dp[g + 8][x];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + 8 * (e >> 1), s = 8 * nt + 2 * q + (e & 1);
        sc[nt][e] = s < t ? sc[nt][e] : (s == t ? diag[e >> 1] : 0.f);
      }
    // v^T fragment (rows j of this warp, k = s), from vs[s][j]
    uint32_t vf[VP][4];
#pragma unroll
    for (int p = 0; p < VP; ++p)
      ldsm_x4_t(vf[p], &tb.vs[p][(lane & 7) + 8 * (lane >> 4)]
                               [16 * w + 8 * ((lane >> 3) & 1)]);
    // o^T += v^T A^T: A^T as B (k = s, n = t)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t b0[kPieces], b1[kPieces];
      split_bf16(sc[0][2 * nt], sc[0][2 * nt + 1], b0);
      split_bf16(sc[1][2 * nt], sc[1][2 * nt + 1], b1);
      mma_split(oa[nt], vf, b0, b1);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * nt + 2 * q + (e & 1);
        if (t < S)
          o[base + static_cast<long long>(t) * step + 16 * w + g +
            8 * (e >> 1)] = Q::out(oa[nt][e]);
      }
    // S^T <- S^T diag(e^{tot}) + v^T kw
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      const float2 wt = *reinterpret_cast<const float2*>(
          &tb.wt[8 * nt + 2 * q]);
      st[nt][0] *= wt.x;
      st[nt][1] *= wt.y;
      st[nt][2] *= wt.x;
      st[nt][3] *= wt.y;
    }
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t bf[kPieces][4];
#pragma unroll
      for (int x = 0; x < kPieces; ++x)
        ldsm_x4_t(bf[x], &tb.kw[x][(lane & 7) + 8 * ((lane >> 3) & 1)]
                                  [16 * kk + 8 * (lane >> 4)]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        uint32_t b0[kPieces], b1[kPieces];
#pragma unroll
        for (int x = 0; x < kPieces; ++x) {
          b0[x] = bf[x][2 * h2];
          b1[x] = bf[x][2 * h2 + 1];
        }
        mma_split(st[2 * kk + h2], vf, b0, b1);
      }
    }
  };

  const int nsub = (S + kSub - 1) / kSub;
  fetch(0);
  __syncthreads();                    // us
  make_tiles(0);
  if (nsub > 1) fetch(kSub);
  __syncthreads();
  const int nsave = (nsub + kPer - 1) / kPer;
  for (int i = 0; i < nsub; ++i) {
    const int b = i & 1;
    if (states && i % kPer == 0) {
      float* dst = states + (bh * nsave + i / kPer) * K * V;
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * w + g + 8 * (e >> 1);
          const int c = 8 * nt + 2 * q + (e & 1);
          dst[c * V + j] = st[nt][e];
        }
    }
    products(b, i * kSub);
    if (i + 1 < nsub) {
      make_tiles(b ^ 1);
      if (i + 2 < nsub) fetch((i + 2) * kSub);
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * w + g + 8 * (e >> 1), c = 8 * nt + 2 * q + (e & 1);
      state_out[(bh * K + c) * V + j] = st[nt][e];
    }
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* state_in,
                   void* o, void* state_out, void* states, long long N,
                   int S, int H, long long u_div, cudaStream_t stream) {
  constexpr int bytes = 2 * sizeof(Tiles<K, kVPieces<T>>);
  static_assert(sizeof(Tiles<K, kVPieces<T>>) % 16 == 0,
                "16-byte aligned second tile");
  const cudaError_t e = cudaFuncSetAttribute(
      rwkv6_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  rwkv6_kernel<T, K><<<static_cast<unsigned>(N * H), 2 * K, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const T*>(u), static_cast<const float*>(state_in),
      static_cast<T*>(o), static_cast<float*>(state_out),
      static_cast<float*>(states), S, H, u_div);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(int dtype, const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* state_in,
                     void* o, void* state_out, void* states, long long N,
                     int S, int H, long long u_div, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, K>(r, k, v, logw, u, state_in, o, state_out,
                            states, N, S, H, u_div, stream);
  return launch<__nv_bfloat16, K>(r, k, v, logw, u, state_in, o, state_out,
                                  states, N, S, H, u_div, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 for r, k, v, u, o. r, k, v, logw, o: (N, S, H,
// K) contiguous, 16-byte aligned (f32) or 8-byte (bf16); u: (G, H, K) with
// G dividing N; state_in: (N, H, K, K) f32 or null (zeros); state_out: (N,
// H, K, K) f32; states: (N, H, ceil(S / 64), K, K) f32 or null (not
// written): the state at steps 0, 64, 128, ... K = V in {16, 32, 64}. Returns the cudaError_t of the
// launch (0 on success); nothing is synchronized and nothing allocated.
int repro_rwkv6_chunked(int dtype, int K, const void* r,
                        const void* k, const void* v, const void* logw,
                        const void* u, const void* state_in, void* o,
                        void* state_out, void* states, long long N, int S,
                        int H, long long G, void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 || G <= 0 || N % G ||
      N * H > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long u_div = N / G;
  switch (K) {
    case 16:
      return launch_k<16>(dtype, r, k, v, logw, u, state_in, o, state_out,
                          states, N, S, H, u_div, s);
    case 32:
      return launch_k<32>(dtype, r, k, v, logw, u, state_in, o, state_out,
                          states, N, S, H, u_div, s);
    case 64:
      return launch_k<64>(dtype, r, k, v, logw, u, state_in, o, state_out,
                          states, N, S, H, u_div, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_rwkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
