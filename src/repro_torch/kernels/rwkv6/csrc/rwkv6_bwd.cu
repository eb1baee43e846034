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
// Algorithm (ref.rwkv6_chunked_backward is the same in PyTorch). The
// forward kernel, asked for them, saves the f32 state at the start of
// each 64-step chunk: (N, H, n_save, K, V). Time runs in 16-step
// sub-chunks, as in the forward (e^{-cum} stays far from f32's limit under
// strong decay). Within a sub-chunk, with cum the inclusive sum of logw,
// excl = cum - logw, tot = cum at its last step, qd = r e^{excl}, kd =
// k e^{-cum}, kw = k e^{tot - cum}, S0 its start state and dS the gradient
// of its end state; P[t, s] = qd_t . kd_s, dP[t, s] = do_t . v_s (s < t),
// D_t = r_t . (u k_t), dD_t = do_t . v_t:
//   dqd_t = S0 do_t + sum_{s<t} dP[t, s] kd_s
//   dkd_s = sum_{t>s} dP[t, s] qd_t,        dkw_s = dS v_s
//   dv_s  = sum_{t>s} P[t, s] do_t + D_s do_s + dS^T kw_s
//   dr = dqd e^{excl} + u k dD,   dk = dkd e^{-cum} + dkw e^{tot-cum}
//        + u r dD,                du += sum_t r_t k_t dD_t
//   dlogw_tau = sum_{t>=tau} (a_t + b_t) - b_tau + dtot: a = -(dkd kd +
//        dkw kw) through cum, b = dqd qd through excl, dtot = sum_s dkw_s
//        kw_s + e^{tot} rowsum(S0 * dS)
//   dS <- e^{tot} dS + sum_t qd_t do_t^T.
// Only the last line carries from one sub-chunk to the one before; every
// other term is local once S0 and dS are known. So two passes:
//
//   Pass 1 (rwkv6_bwd_state_kernel): the chain dS <- e^{tot} dS + qd^T do
//   alone, last sub-chunk to first, writing dS at each 64-step chunk's end
//   into an f32 scratch (N, H, n_save, K, V), and dstate_in. dS's columns
//   are independent and qd^T do needs only the warp's own channels, so a
//   warp owns 16 key channels by kStateCols value columns of one (batch,
//   head), its rows in mma accumulators: no shared memory, no barrier. A
//   lane loads r and logw as the A fragment of qd^T and do as the B
//   fragment of its product, takes the cumsum as a shuffle scan over the
//   four lanes that share a channel, and loads the earlier sub-chunk's
//   inputs a sub-chunk ahead.
//
//   Pass 2 (rwkv6_bwd_chunk_kernel): one CTA of K / 16 warps per (batch,
//   head, 64-step chunk), from the chunk's saved start state and pass 1's
//   gradient at its end. It rebuilds the three inner sub-chunk start
//   states with the forward's update S <- e^{tot} S + kw^T v (kept in
//   shared memory, each lane's accumulator registers as they are), then
//   sweeps the chunk's sub-chunks last to first with dS in registers. Warp
//   w owns key channels and value columns [16 w, 16 w + 16): S0 and dS
//   rows as accumulators (whose layout is the B fragment of do S0^T and of
//   v dS^T), dqd, dkd, dkw for its channels, dv for its columns. A sub-
//   chunk's operands go to shared memory as bf16 pieces (qd, kd, kw, v, do
//   and dS) and reach the products through ldmatrix; P^T, dP and dP^T are
//   16 x 16 products every warp takes itself (dP^T by movmatrix from dP's
//   pieces), dD is dP's diagonal. The cumsum and dlogw's reverse sum are
//   shuffle scans over the eight lanes that share a channel; two barriers
//   a sub-chunk (operands written / read), and the next sub-chunk's
//   inputs load into registers while the products run.
//
// Every product runs on tensor cores: mma.sync m16n8k16 with f32
// accumulators. To keep the arithmetic f32, every f32 operand (qd, kd, kw,
// S0, dS, P^T, dP, and v and do when they come in f32) is split into three
// bf16 pieces (24 mantissa bits) and each product takes the piece products
// above f32's last bit (mma_split), as the forward does; a bf16 input is
// exact in one piece.
//
// Deterministic: no atomics. Pass 2 writes each chunk's du into an f32
// scratch (N, H, n_save, K); a third kernel sums the rows that share a u
// and their chunks in a fixed order and writes du in u's type.
//
// Steps past S are zero (r, k, v, do) with logw 0: they add nothing.
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, at
// rwkv6-7b's training shapes (4, 1024, 64, 64) and (32, 1024, 8, 64) in
// bf16; PERF.md section 6): the call takes 0.61-0.62 ms against a bytes
// bound of 0.110 ms (the gradient's 369 MB; the design moves 203 MB more:
// the saved states read, pass 1's chunk-end gradients written and read).
//   Pass 1, 0.107 ms: its loads. Each warp reads r and logw of its 16
//   channels and do of all its columns, element by element in the
//   fragment layouts, so do is read once per 16 channels (4 times at K =
//   64) through L1 / L2; 64 columns a warp beat 32 (0.109-0.112 ms) and 16
//   (0.184 ms: do read 4 times more; tools/rwkv6_bwd_state_cols.py).
//   Pass 2, 0.49-0.50 ms: instruction issue and latency at two CTAs of
//   four warps an SM (registers and shared memory allow no third). Its
//   products are about 3,600 mma a CTA (0.13 ms of tensor-core time over
//   the card), the three-piece splits and the decays about as many
//   instructions again, with two barriers a sub-chunk. The design keeps
//   the chain in pass 1 (a few mma a sub-chunk, no barrier) so that pass
//   2's 4,096 CTAs (16 times the 256 (batch, head) pairs) fill the card.
//
// Build (nvcc -O3, sm_90a), K = 64 / 32 / 16, no spill anywhere: pass 2
// 252 / 199 / 200 registers in bf16, 242 / 216 / 234 in f32, 102.7 KB of
// dynamic shared memory in bf16 and 111.9 KB in f32 at K = 64; pass 1 136
// / 96 / 70 registers in bf16, 167 / 122 / 80 in f32, no shared memory;
// the du sum 32. cuobjdump -sass: HMMA in pass 2 (116 / 92 / 80 in bf16,
// 192 / 144 / 120 in f32, loop bodies once) and pass 1 (24 / 12 / 6, 48 /
// 24 / 12), MOVM 12, no HGMMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSub = 16;           // steps per sub-chunk: the forward's
constexpr int kSave = 64;          // steps between the forward's saved states
constexpr int kPer = kSave / kSub;
constexpr int kStateCols = 64;     // pass 1: value columns a warp owns
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPieces = 3;

using bf16 = __nv_bfloat16;

// Two consecutive elements of an input, as loaded (raw) and in f32.
template <typename T>
struct Two;

template <>
struct Two<float> {
  using raw = float2;
  __device__ __forceinline__ static raw load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ static raw zero() { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ static float2 f32(raw x) { return x; }
  __device__ __forceinline__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Two<bf16> {
  using raw = __nv_bfloat162;
  __device__ __forceinline__ static raw load(const bf16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ __forceinline__ static raw zero() {
    return __floats2bfloat162_rn(0.f, 0.f);
  }
  __device__ __forceinline__ static float2 f32(raw x) {
    return __bfloat1622float2(x);
  }
  __device__ __forceinline__ static void store(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
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
// the transpose of an 8 x 8 bf16 fragment (lane g * 4 + q: row g, columns
// 2 q and 2 q + 1)
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}
// c += a b for a 16 x 16 bf16 A fragment and a 16 x 8 B fragment (b0, b1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as NP bf16 pairs, each the bf16 rounding of what the ones
// before leave (NP = 1: a bf16 input, exact in one)
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
// the f32 product a b to within f32 rounding. A has NA pieces, B NB (1
// where the operand is exact in bf16).
template <int NA, int NB>
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b0)[NB],
                                          const uint32_t (&b1)[NB]) {
#pragma unroll
  for (int d = kPieces - 1; d >= 0; --d)
#pragma unroll
    for (int i = 0; i <= d; ++i)
      if (i < NA && d - i < NB) mma_bf16(c, a[i], b0[d - i], b1[d - i]);
}

// pieces of a B operand held as ldmatrix's four registers per piece:
// n-tile nt's (b0, b1) are registers 2 nt and 2 nt + 1
template <int NP>
__device__ __forceinline__ void b_of(const uint32_t (&x)[NP][4], int nt,
                                     uint32_t (&b0)[NP], uint32_t (&b1)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    b0[p] = x[p][2 * nt];
    b1[p] = x[p][2 * nt + 1];
  }
}

// a 16 x 16 f32 accumulator (two n-tiles) as the pieces of an A fragment
__device__ __forceinline__ void a_of(const float (&c)[2][4],
                                     uint32_t (&a)[kPieces][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    uint32_t p[kPieces];
    split_bf16(c[x >> 1][2 * (x & 1)], c[x >> 1][2 * (x & 1) + 1], p);
#pragma unroll
    for (int i = 0; i < kPieces; ++i) a[i][x] = p[i];
  }
}

// v's and do's bf16 pieces: one for a bf16 input, kPieces for f32
template <typename T>
constexpr int kVPieces = std::is_same<T, float>::value ? kPieces : 1;

// ------------------------------------------------------------------ pass 1
// r, logw: (N, S, H, K); d_o: (N, S, H, V) (V == K); dstate_out (may be
// null), dstate_in (may be null): (N, H, K, V) f32; ends: (N, H, n_save, K,
// V) f32, entry c the gradient of the state at the end of chunk c. One warp
// per (batch, head, 16 key channels, JW value columns), four warps a CTA.
template <typename T, int K>
__global__ void __launch_bounds__(128)
rwkv6_bwd_state_kernel(const T* __restrict__ r, const float* __restrict__ logw,
                       const T* __restrict__ d_o,
                       const float* __restrict__ dstate_out,
                       float* __restrict__ ends, float* __restrict__ dstate_in,
                       long long N, int S, int H) {
  constexpr int V = K;
  constexpr int JW = kStateCols < K ? kStateCols : K;
  constexpr int NT = JW / 8;            // n-tiles of the warp's columns
  constexpr int CB = K / 16, JB = K / JW;
  constexpr int VP = kVPieces<T>;
  const int lane = threadIdx.x & 31;
  const long long gw = blockIdx.x * 4LL + (threadIdx.x >> 5);
  if (gw >= N * H * CB * JB) return;
  const long long bh = gw / (CB * JB);
  const int cb = static_cast<int>(gw % (CB * JB)) / JB;
  const int jb = static_cast<int>(gw % JB);
  const long long n = bh / H;
  const int h = static_cast<int>(bh % H);
  const long long step = static_cast<long long>(H) * K;
  const long long base = n * S * step + static_cast<long long>(h) * K;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = 16 * cb + g;           // rows c0 and c0 + 8
  const int j0 = JW * jb + g;           // do's B columns j0 + 8 nt
  const int nsub = (S + kSub - 1) / kSub;
  const int nsave = (nsub + kPer - 1) / kPer;

  // ds[nt]: rows c0 (+ 8 for [2], [3]), columns JW jb + 8 nt + 2 q (+ 1)
  float ds[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2 x = make_float2(0.f, 0.f);
      if (dstate_out)
        x = *reinterpret_cast<const float2*>(
            dstate_out + (bh * K + c0 + 8 * hf) * V + JW * jb + 8 * nt +
            2 * q);
      ds[nt][2 * hf] = x.x;
      ds[nt][2 * hf + 1] = x.y;
    }
  auto store = [&](float* dst) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(dst + (c0 + 8 * hf) * V + JW * jb +
                                   8 * nt + 2 * q) =
            make_float2(ds[nt][2 * hf], ds[nt][2 * hf + 1]);
  };

  // the next sub-chunk's inputs: steps 2 q, 2 q + 1, 2 q + 8, 2 q + 9 of
  // channels c0, c0 + 8 (r, logw) and of columns j0 + 8 nt (do)
  T rr[2][4], dd[NT][4];
  float lw[2][4];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = t0 + 2 * q + (x & 1) + 8 * (x >> 1);
      const bool in = t < S;
      const long long off = base + static_cast<long long>(t) * step;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        rr[hf][x] = in ? r[off + c0 + 8 * hf] : from_f32<T>(0.f);
        lw[hf][x] = in ? logw[off + c0 + 8 * hf] : 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        dd[nt][x] = in ? d_o[off + j0 + 8 * nt] : from_f32<T>(0.f);
    }
  };

  fetch((nsub - 1) * kSub);
  for (int i = nsub - 1; i >= 0; --i) {
    if (i == nsub - 1 || i % kPer == kPer - 1)
      store(ends + (bh * nsave + i / kPer) * K * V);
    // qd^T's A fragment (rows c0, c0 + 8; k = the steps) and e^{tot}: the
    // cumsum over the 16 steps of a channel, held by the four lanes of one
    // g, as an inclusive scan of each lane's step pairs
    float qd[2][4], wt[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float l[4] = {lw[hf][0], lw[hf][1], lw[hf][2], lw[hf][3]};
      float plo = l[0] + l[1], phi = l[2] + l[3];
#pragma unroll
      for (int d = 1; d < 4; d *= 2) {
        const float ylo = __shfl_up_sync(kFull, plo, d, 4);
        const float yhi = __shfl_up_sync(kFull, phi, d, 4);
        if (q >= d) {
          plo += ylo;
          phi += yhi;
        }
      }
      const float tlo = __shfl_sync(kFull, plo, 3, 4);
      const float thi = __shfl_sync(kFull, phi, 3, 4);
      float elo = __shfl_up_sync(kFull, plo, 1, 4);
      float ehi = __shfl_up_sync(kFull, phi, 1, 4);
      if (q == 0) elo = ehi = 0.f;
      const float ex[4] = {elo, elo + l[0], tlo + ehi, tlo + ehi + l[2]};
#pragma unroll
      for (int x = 0; x < 4; ++x) qd[hf][x] = to_f32(rr[hf][x]) * expf(ex[x]);
      wt[hf] = expf(tlo + thi);
    }
    uint32_t a[kPieces][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {   // a[x]: row c0 + 8 (x & 1), steps 8 (x >> 1)
      uint32_t p[kPieces];
      split_bf16(qd[x & 1][2 * (x >> 1)], qd[x & 1][2 * (x >> 1) + 1], p);
#pragma unroll
      for (int y = 0; y < kPieces; ++y) a[y][x] = p[y];
    }
    uint32_t b[NT][2][VP];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split_bf16(to_f32(dd[nt][0]), to_f32(dd[nt][1]), b[nt][0]);
      split_bf16(to_f32(dd[nt][2]), to_f32(dd[nt][3]), b[nt][1]);
    }
    if (i > 0) fetch((i - 1) * kSub);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      ds[nt][0] *= wt[0];
      ds[nt][1] *= wt[0];
      ds[nt][2] *= wt[1];
      ds[nt][3] *= wt[1];
      mma_split<kPieces, VP>(ds[nt], a, b[nt][0], b[nt][1]);
    }
  }
  if (dstate_in) store(dstate_in + bh * K * V);
}

// ------------------------------------------------------------------ pass 2
// One sub-chunk's operands in bf16 pieces, rows padded by 8 elements
// (ldmatrix and the pair stores are conflict-free), and the inner states.
template <int K, int VP>
struct Smem {
  static constexpr int KP = K + 8, NW = K / 16;
  // S_1 .. S_3: each lane's accumulator registers, as they are
  float4 inner[kPer - 1][NW][K / 8][32];
  bf16 qd[kPieces][kSub][KP];   // r_t e^{excl_t}
  bf16 kd[kPieces][kSub][KP];   // k_s e^{-cum_s}
  bf16 kw[kPieces][kSub][KP];   // k_s e^{tot - cum_s}
  bf16 vs[VP][kSub][KP];
  bf16 dos[VP][kSub][KP];
  bf16 ds[kPieces][K][KP];      // dS (key channel, value column)
  float wt[K];                  // e^{tot}
  float dsum[kSub][NW];         // r_t u k_t over each warp's channels
};

// r, k, v, d_o, dr, dk, dv: (N, S, H, K) in T; logw, dlogw: (N, S, H, K)
// f32; u: (G, H, K) in T, row n reads u row n / u_div; states, ends: (N, H,
// n_save, K, K) f32; du_parts: (N, H, n_save, K) f32. grid = N * H * n_save
// (chunk fastest), block = 2 K threads; Smem<K, VP> of dynamic shared
// memory.
template <typename T, int K>
__global__ void __launch_bounds__(2 * K, 2)
rwkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ logw,
                       const T* __restrict__ u, const float* __restrict__ states,
                       const T* __restrict__ d_o,
                       const float* __restrict__ ends, T* __restrict__ dr,
                       T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ dlogw, float* __restrict__ du_parts,
                       int S, int H, long long u_div) {
  using X2 = Two<T>;
  constexpr int V = K;
  constexpr int NW = K / 16;
  constexpr int VP = kVPieces<T>;
  constexpr int KP = Smem<K, VP>::KP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<K, VP>& sm = *reinterpret_cast<Smem<K, VP>*>(smem_raw);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int nsub = (S + kSub - 1) / kSub;
  const int nsave = (nsub + kPer - 1) / kPer;
  const long long bh = blockIdx.x / nsave;
  const int ch = static_cast<int>(blockIdx.x % nsave);
  const long long n = bh / H;
  const int h = static_cast<int>(bh % H);
  const long long step = static_cast<long long>(H) * K;
  const long long base = n * S * step + static_cast<long long>(h) * K;
  const int cw = 16 * w;                  // the warp's channels / columns
  const float* s0g = states + (bh * nsave + ch) * K * V;
  const int first = ch * kPer;
  const int m = min(kPer, nsub - first);  // sub-chunks of this chunk

  // the lane's elementwise positions: steps g + 8 hr, channels cw + 8 cp +
  // 2 q (+ e); its four u values
  float uu[2][2];
#pragma unroll
  for (int cp = 0; cp < 2; ++cp) {
    const float2 x = X2::f32(X2::load(
        u + (n / u_div) * step + static_cast<long long>(h) * K + cw + 8 * cp +
        2 * q));
    uu[cp][0] = x.x;
    uu[cp][1] = x.y;
  }

  // a sub-chunk's inputs, in registers a sub-chunk ahead
  typename X2::raw xr[2][2], xk[2][2], xv[2][2], xo[2][2];
  float2 xl[2][2];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t0 + g + 8 * hr;
      const bool in = t < S;
      const long long row = base + static_cast<long long>(t) * step + cw +
                            2 * q;
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        const long long off = row + 8 * cp;
        xr[hr][cp] = in ? X2::load(r + off) : X2::zero();
        xk[hr][cp] = in ? X2::load(k + off) : X2::zero();
        xv[hr][cp] = in ? X2::load(v + off) : X2::zero();
        xo[hr][cp] = in ? X2::load(d_o + off) : X2::zero();
        xl[hr][cp] = in ? *reinterpret_cast<const float2*>(logw + off)
                        : make_float2(0.f, 0.f);
      }
    }
  };

  // kept from the tiles for the elementwise pass: r and k as loaded
  // ([hr][cp]), the decays ([hr][cp][e])
  typename X2::raw kr[2][2], kk2[2][2];
  float eex[2][2][2], enc[2][2][2], etc[2][2][2];
  // registers -> the sub-chunk's tiles: the cumsum over its 16 steps (held
  // by the eight lanes of one q, two steps each) as a shuffle scan, the
  // decays, the pieces, e^{tot} and the warp's part of D; for the rebuild
  // (all = false) only kw, v and e^{tot}
  auto make_tiles = [&](auto all) {
    constexpr bool kAll = decltype(all)::value;
    float cum[2][2][2], tot[2][2], lg[2][2][2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        lg[hr][cp][0] = xl[hr][cp].x;
        lg[hr][cp][1] = xl[hr][cp].y;
      }
#pragma unroll
    for (int cp = 0; cp < 2; ++cp)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float lo = lg[0][cp][e], hi = lg[1][cp][e];
#pragma unroll
        for (int d = 1; d < 8; d *= 2) {
          const float ylo = __shfl_up_sync(kFull, lo, 4 * d);
          const float yhi = __shfl_up_sync(kFull, hi, 4 * d);
          if (g >= d) {
            lo += ylo;
            hi += yhi;
          }
        }
        hi += __shfl_sync(kFull, lo, 28 + q);
        cum[0][cp][e] = lo;
        cum[1][cp][e] = hi;
        tot[cp][e] = __shfl_sync(kFull, hi, 28 + q);
      }
    float dpart[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        kr[hr][cp] = xr[hr][cp];
        kk2[hr][cp] = xk[hr][cp];
        const float2 r2 = X2::f32(xr[hr][cp]), k2 = X2::f32(xk[hr][cp]);
        const float rr[2] = {r2.x, r2.y}, kk[2] = {k2.x, k2.y};
        float qd[2], kd[2], kw[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cu = cum[hr][cp][e];
          eex[hr][cp][e] = expf(cu - lg[hr][cp][e]);
          enc[hr][cp][e] = expf(-cu);
          etc[hr][cp][e] = expf(tot[cp][e] - cu);
          qd[e] = rr[e] * eex[hr][cp][e];
          kd[e] = kk[e] * enc[hr][cp][e];
          kw[e] = kk[e] * etc[hr][cp][e];
          dpart[hr] += rr[e] * uu[cp][e] * kk[e];
        }
        const int t = g + 8 * hr, c = cw + 8 * cp + 2 * q;
        uint32_t p[kPieces], pv[VP];
        if (kAll) {
          split_bf16(qd[0], qd[1], p);
#pragma unroll
          for (int y = 0; y < kPieces; ++y)
            *reinterpret_cast<uint32_t*>(&sm.qd[y][t][c]) = p[y];
          split_bf16(kd[0], kd[1], p);
#pragma unroll
          for (int y = 0; y < kPieces; ++y)
            *reinterpret_cast<uint32_t*>(&sm.kd[y][t][c]) = p[y];
          const float2 o2 = X2::f32(xo[hr][cp]);
          split_bf16(o2.x, o2.y, pv);
#pragma unroll
          for (int y = 0; y < VP; ++y)
            *reinterpret_cast<uint32_t*>(&sm.dos[y][t][c]) = pv[y];
        }
        split_bf16(kw[0], kw[1], p);
#pragma unroll
        for (int y = 0; y < kPieces; ++y)
          *reinterpret_cast<uint32_t*>(&sm.kw[y][t][c]) = p[y];
        const float2 v2 = X2::f32(xv[hr][cp]);
        split_bf16(v2.x, v2.y, pv);
#pragma unroll
        for (int y = 0; y < VP; ++y)
          *reinterpret_cast<uint32_t*>(&sm.vs[y][t][c]) = pv[y];
      }
    if (kAll)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dpart[hr] += __shfl_xor_sync(kFull, dpart[hr], 1);
        dpart[hr] += __shfl_xor_sync(kFull, dpart[hr], 2);
        if (q == 0) sm.dsum[g + 8 * hr][w] = dpart[hr];
      }
    if (g == 0)
#pragma unroll
      for (int cp = 0; cp < 2; ++cp)
        *reinterpret_cast<float2*>(&sm.wt[cw + 8 * cp + 2 * q]) =
            make_float2(expf(tot[cp][0]), expf(tot[cp][1]));
  };

  // ldmatrix addresses, 16 x 16 blocks of a [row][col] tile: A of the tile
  // (rows r0, k = cols c0), A of its transpose (m = cols c0, k = rows r0),
  // B of the tile read as [n][k] (n = rows r0) and as [k][n] (k = rows r0):
  // registers 2 nt, 2 nt + 1 hold n-tile nt's (b0, b1)
  const int la = lane & 15, lb = 8 * (lane >> 4);
  const int l7 = lane & 7, l8 = 8 * ((lane >> 3) & 1);
#define A_AT(tile, r0, c0) (&(tile)[(r0) + la][(c0) + lb])
#define AT_AT(tile, r0, c0) (&(tile)[(r0) + l7 + lb][(c0) + l8])
#define BN_AT(tile, r0, c0) (&(tile)[(r0) + l7 + lb][(c0) + l8])
#define BK_AT(tile, r0, c0) (&(tile)[(r0) + l7 + l8][(c0) + lb])

  // the rebuild's state (ss) and dS: rows cw + g (+ 8 for [2], [3]),
  // columns 8 nt + 2 q (+ 1)
  float ds[K / 8][4];
  auto load_rows = [&](float (&x)[K / 8][4], const float* src) {
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 y = *reinterpret_cast<const float2*>(
            src + (cw + g + 8 * hf) * V + 8 * nt + 2 * q);
        x[nt][2 * hf] = y.x;
        x[nt][2 * hf + 1] = y.y;
      }
  };
  // rows of x by e^{tot}, then x += (A^T)^T B over the sub-chunk's steps:
  // A^T from the [step][channel] tile at, B the [step][column] tile bk
  auto advance = [&](float (&x)[K / 8][4], const bf16 (*at)[kSub][KP],
                     const bf16 (*bk)[kSub][KP]) {
    const float w0 = sm.wt[cw + g], w1 = sm.wt[cw + g + 8];
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      x[nt][0] *= w0;
      x[nt][1] *= w0;
      x[nt][2] *= w1;
      x[nt][3] *= w1;
    }
    uint32_t ta[kPieces][4];
#pragma unroll
    for (int p = 0; p < kPieces; ++p) ldsm_x4_t(ta[p], AT_AT(at[p], 0, cw));
#pragma unroll
    for (int jj = 0; jj < K / 16; ++jj) {
      uint32_t bb[VP][4], b0[VP], b1[VP];
#pragma unroll
      for (int p = 0; p < VP; ++p) ldsm_x4_t(bb[p], BK_AT(bk[p], 0, 16 * jj));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        b_of(bb, nt, b0, b1);
        mma_split<kPieces, VP>(x[2 * jj + nt], ta, b0, b1);
      }
    }
  };

  float du_acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  // sub-chunk i of the chunk, from the tiles: dv, then dP with the S0 and
  // dS terms, dqd, dkd, dkw, the elementwise outputs, then dS's update
  auto products = [&](int i) {
    const int t0 = (first + i) * kSub;
    float dsv[2];                 // D_s of rows g, g + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < NW; ++x) acc += sm.dsum[g + 8 * hr][x];
      dsv[hr] = acc;
    }
    // P^T (rows s, columns t): kd qd^T, kept where t > s, D_s on t == s
    uint32_t pa[kPieces][4];
    {
      float pt[2][4] = {};
#pragma unroll 1
      for (int kk = 0; kk < K / 16; ++kk) {
        uint32_t ka[kPieces][4], qb[kPieces][4], b0[kPieces], b1[kPieces];
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          ldsm_x4(ka[p], A_AT(sm.kd[p], 0, 16 * kk));
          ldsm_x4(qb[p], BN_AT(sm.qd[p], 0, 16 * kk));
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          b_of(qb, nt, b0, b1);
          mma_split<kPieces, kPieces>(pt[nt], ka, b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = g + 8 * (e >> 1), t = 8 * nt + 2 * q + (e & 1);
          pt[nt][e] = t > s ? pt[nt][e] : (t == s ? dsv[e >> 1] : 0.f);
        }
      a_of(pt, pa);
    }
    // dv (rows s, the warp's columns) = P^T do + kw dS
    {
      float dvv[2][4] = {};
      uint32_t db[VP][4], b0[kPieces], b1[kPieces];
      uint32_t c0[VP], c1[VP];
#pragma unroll
      for (int p = 0; p < VP; ++p) ldsm_x4_t(db[p], BK_AT(sm.dos[p], 0, cw));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        b_of(db, nt, c0, c1);
        mma_split<kPieces, VP>(dvv[nt], pa, c0, c1);
      }
#pragma unroll 1
      for (int kk = 0; kk < K / 16; ++kk) {
        uint32_t kwa[kPieces][4], dsb[kPieces][4];
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          ldsm_x4(kwa[p], A_AT(sm.kw[p], 0, 16 * kk));
          ldsm_x4_t(dsb[p], BK_AT(sm.ds[p], 16 * kk, cw));
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          b_of(dsb, nt, b0, b1);
          mma_split<kPieces, kPieces>(dvv[nt], kwa, b0, b1);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + g + 8 * hr;
        if (t < S)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            X2::store(dv + base + static_cast<long long>(t) * step + cw +
                          8 * nt + 2 * q,
                      dvv[nt][2 * hr], dvv[nt][2 * hr + 1]);
      }
    }
    // S0 at rows cw + g (+ 8 for [2], [3]), columns 8 nt + 2 q (+ 1), in
    // the accumulator layout: S_i from shared memory, S_0 the saved state
    auto s0_tile = [&](int nt) {
      if (i > 0) return sm.inner[i - 1][w][nt][lane];
      const float2 a = *reinterpret_cast<const float2*>(
          s0g + (cw + g) * V + 8 * nt + 2 * q);
      const float2 b = *reinterpret_cast<const float2*>(
          s0g + (cw + g + 8) * V + 8 * nt + 2 * q);
      return make_float4(a.x, a.y, b.x, b.y);
    };
    // over the value columns: dP = do v^T, dqd = do S0^T, dkw = v dS^T
    // (dS's B fragments from its pieces in shared memory)
    float dp[2][4] = {}, dq[2][4] = {}, dw[2][4] = {};
#pragma unroll 1
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t doa[VP][4], vb[VP][4], va[VP][4], c0[VP], c1[VP];
#pragma unroll
      for (int p = 0; p < VP; ++p) {
        ldsm_x4(doa[p], A_AT(sm.dos[p], 0, 16 * kk));
        ldsm_x4(vb[p], BN_AT(sm.vs[p], 0, 16 * kk));
        ldsm_x4(va[p], A_AT(sm.vs[p], 0, 16 * kk));
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        b_of(vb, nt, c0, c1);
        mma_split<VP, VP>(dp[nt], doa, c0, c1);
      }
      const float4 z0 = s0_tile(2 * kk), z1 = s0_tile(2 * kk + 1);
      uint32_t dsb[kPieces][4], b0[kPieces], b1[kPieces];
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
        ldsm_x4(dsb[p], BN_AT(sm.ds[p], cw, 16 * kk));
      // n-tile ct: key channels cw + 8 ct + g
      split_bf16(z0.x, z0.y, b0);
      split_bf16(z1.x, z1.y, b1);
      mma_split<VP, kPieces>(dq[0], doa, b0, b1);
      split_bf16(z0.z, z0.w, b0);
      split_bf16(z1.z, z1.w, b1);
      mma_split<VP, kPieces>(dq[1], doa, b0, b1);
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        b_of(dsb, ct, b0, b1);
        mma_split<VP, kPieces>(dw[ct], va, b0, b1);
      }
    }
    // the rows of S0 * dS (dS before its update)
    float rho[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      const float4 z = s0_tile(nt);
      rho[0] += z.x * ds[nt][0] + z.y * ds[nt][1];
      rho[1] += z.z * ds[nt][2] + z.w * ds[nt][3];
    }
    // dD_t: dP's diagonal, held by lane 4 g + g / 2 of each row group
    float ddv[2];
    {
      const float lo = (g & 1) ? dp[0][1] : dp[0][0];
      const float hi = (g & 1) ? dp[1][3] : dp[1][2];
      ddv[0] = __shfl_sync(kFull, lo, 4 * g + (g >> 1));
      ddv[1] = __shfl_sync(kFull, hi, 4 * g + (g >> 1));
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + 8 * (e >> 1), s = 8 * nt + 2 * q + (e & 1);
        if (s >= t) dp[nt][e] = 0.f;
      }
    // dqd += dP kd; dkd = dP^T qd (dP^T's pieces by movmatrix)
    float dkk[2][4] = {};
    {
      uint32_t dpa[kPieces][4], bb[kPieces][4], b0[kPieces], b1[kPieces];
      a_of(dp, dpa);
#pragma unroll
      for (int p = 0; p < kPieces; ++p) ldsm_x4_t(bb[p], BK_AT(sm.kd[p], 0, cw));
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        b_of(bb, ct, b0, b1);
        mma_split<kPieces, kPieces>(dq[ct], dpa, b0, b1);
      }
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {   // dpa becomes dP^T
        const uint32_t x1 = dpa[p][1];
        dpa[p][0] = movt(dpa[p][0]);
        dpa[p][1] = movt(dpa[p][2]);
        dpa[p][2] = movt(x1);
        dpa[p][3] = movt(dpa[p][3]);
      }
#pragma unroll
      for (int p = 0; p < kPieces; ++p) ldsm_x4_t(bb[p], BK_AT(sm.qd[p], 0, cw));
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        b_of(bb, ct, b0, b1);
        mma_split<kPieces, kPieces>(dkk[ct], dpa, b0, b1);
      }
    }
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) {
      rho[ct] += __shfl_xor_sync(kFull, rho[ct], 1);
      rho[ct] += __shfl_xor_sync(kFull, rho[ct], 2);
    }
    // the elementwise outputs at steps g + 8 hr, channels cw + 8 cp + 2 q +
    // e (dq / dkk / dw [cp][2 hr + e])
#pragma unroll
    for (int cp = 0; cp < 2; ++cp) {
      float o_r[2][2], o_k[2][2], o_w[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float z[2], bq[2], sw = 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float dqv = dq[cp][2 * hr + e], dkv = dkk[cp][2 * hr + e];
          const float dwv = dw[cp][2 * hr + e];
          const float2 r2 = X2::f32(kr[hr][cp]), k2 = X2::f32(kk2[hr][cp]);
          const float rv = e ? r2.y : r2.x, kv = e ? k2.y : k2.x;
          const float ud = uu[cp][e] * ddv[hr];
          const float kdv = kv * enc[hr][cp][e], kwv = kv * etc[hr][cp][e];
          o_r[hr][e] = dqv * eex[hr][cp][e] + ud * kv;
          o_k[hr][e] = dkv * enc[hr][cp][e] + dwv * etc[hr][cp][e] + ud * rv;
          du_acc[cp][e] += rv * kv * ddv[hr];
          bq[hr] = dqv * (rv * eex[hr][cp][e]);
          z[hr] = bq[hr] - dkv * kdv - dwv * kwv;
          sw += dwv * kwv;
        }
#pragma unroll
        for (int d = 4; d < 32; d *= 2) sw += __shfl_xor_sync(kFull, sw, d);
        const float rc = __shfl_sync(kFull, rho[cp], 4 * (2 * q + e));
        const float dtot = sw + sm.wt[cw + 8 * cp + 2 * q + e] * rc;
        // sum over steps >= tau: the eight lanes of one q, last to first
#pragma unroll
        for (int d = 1; d < 8; d *= 2) {
          const float y0 = __shfl_down_sync(kFull, z[0], 4 * d);
          const float y1 = __shfl_down_sync(kFull, z[1], 4 * d);
          if (g + d < 8) {
            z[0] += y0;
            z[1] += y1;
          }
        }
        z[0] += __shfl_sync(kFull, z[1], q);
        o_w[0][e] = z[0] - bq[0] + dtot;
        o_w[1][e] = z[1] - bq[1] + dtot;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + g + 8 * hr;
        if (t < S) {
          const long long off = base + static_cast<long long>(t) * step + cw +
                                8 * cp + 2 * q;
          X2::store(dr + off, o_r[hr][0], o_r[hr][1]);
          X2::store(dk + off, o_k[hr][0], o_k[hr][1]);
          *reinterpret_cast<float2*>(dlogw + off) =
              make_float2(o_w[hr][0], o_w[hr][1]);
        }
      }
    }
    // dS <- e^{tot} dS + qd^T do
    advance(ds, sm.qd, sm.dos);
  };

  // the chunk's steps: rebuild S_1 .. S_{m-1} from sub-chunks 0 .. m - 2,
  // then take sub-chunks m - 1 .. 0 last to first; inputs load a step ahead
  fetch(first * kSub);
  if (m > 1) {
    float ss[K / 8][4];
    load_rows(ss, s0g);
    for (int i = 0; i < m - 1; ++i) {
      make_tiles(std::false_type());
      fetch((first + i + 1) * kSub);
      __syncthreads();
      advance(ss, sm.kw, sm.vs);
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt)
        sm.inner[i][w][nt][lane] =
            make_float4(ss[nt][0], ss[nt][1], ss[nt][2], ss[nt][3]);
      __syncthreads();
    }
  }
  load_rows(ds, ends + (bh * nsave + ch) * K * V);
  for (int i = m - 1; i >= 0; --i) {
    make_tiles(std::true_type());
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt)   // dS's pieces, for dv
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t p[kPieces];
        split_bf16(ds[nt][2 * hf], ds[nt][2 * hf + 1], p);
#pragma unroll
        for (int y = 0; y < kPieces; ++y)
          *reinterpret_cast<uint32_t*>(
              &sm.ds[y][cw + g + 8 * hf][8 * nt + 2 * q]) = p[y];
      }
    if (i > 0) fetch((first + i - 1) * kSub);
    __syncthreads();
    products(i);
    __syncthreads();
  }
#undef A_AT
#undef AT_AT
#undef BN_AT
#undef BK_AT

  // the chunk's du: the sum over the 16 steps' lanes
#pragma unroll
  for (int cp = 0; cp < 2; ++cp)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int d = 4; d < 32; d *= 2)
        du_acc[cp][e] += __shfl_xor_sync(kFull, du_acc[cp][e], d);
  if (g == 0)
#pragma unroll
    for (int cp = 0; cp < 2; ++cp)
      *reinterpret_cast<float2*>(du_parts + (bh * nsave + ch) * K + cw +
                                 8 * cp + 2 * q) =
          make_float2(du_acc[cp][0], du_acc[cp][1]);
}

// du (G, H, K) in T = the sum, rows of each u row in order and each row's
// chunks in order, of du_parts (N, H, n_save, K). One thread per (g, h, c).
template <typename T>
__global__ void rwkv6_du_kernel(const float* __restrict__ du_parts,
                                T* __restrict__ du, long long G, int H, int K,
                                int nsave, long long u_div) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const long long HK = static_cast<long long>(H) * K;
  if (i >= G * HK) return;
  const long long g = i / HK;
  const int hh = static_cast<int>(i % HK) / K, c = static_cast<int>(i % K);
  float acc = 0.f;
  for (long long m = 0; m < u_div; ++m) {
    const float* p = du_parts + ((g * u_div + m) * H + hh) * nsave * K + c;
    for (int ch = 0; ch < nsave; ++ch) acc += p[ch * K];
  }
  du[i] = from_f32<T>(acc);
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* states,
                   const void* d_o, const void* dstate_out, void* dr,
                   void* dk, void* dv, void* dlogw, void* du, void* ends,
                   void* du_parts, void* dstate_in, long long N, int S,
                   int H, long long G, cudaStream_t stream) {
  constexpr int JW = kStateCols < K ? kStateCols : K;
  const int nsub = (S + kSub - 1) / kSub;
  const int nsave = (nsub + kPer - 1) / kPer;
  const long long warps = N * H * (K / 16) * (K / JW);
  if ((warps + 3) / 4 > 0x7fffffffLL || N * H * nsave > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  rwkv6_bwd_state_kernel<T, K><<<static_cast<unsigned>((warps + 3) / 4), 128,
                                 0, stream>>>(
      static_cast<const T*>(r), static_cast<const float*>(logw),
      static_cast<const T*>(d_o), static_cast<const float*>(dstate_out),
      static_cast<float*>(ends), static_cast<float*>(dstate_in), N, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int bytes = sizeof(Smem<K, kVPieces<T>>);
  e = cudaFuncSetAttribute(rwkv6_bwd_chunk_kernel<T, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long u_div = N / G;
  rwkv6_bwd_chunk_kernel<T, K><<<static_cast<unsigned>(N * H * nsave), 2 * K,
                                 bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const T*>(u), static_cast<const float*>(states),
      static_cast<const T*>(d_o), static_cast<const float*>(ends),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dlogw), static_cast<float*>(du_parts), S, H, u_div);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = G * H * K;
  rwkv6_du_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                       stream>>>(static_cast<const float*>(du_parts),
                                 static_cast<T*>(du), G, H, K, nsave, u_div);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(int dtype, const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* states,
                     const void* d_o, const void* dstate_out, void* dr,
                     void* dk, void* dv, void* dlogw, void* du, void* ends,
                     void* du_parts, void* dstate_in, long long N, int S,
                     int H, long long G, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, K>(r, k, v, logw, u, states, d_o, dstate_out, dr,
                            dk, dv, dlogw, du, ends, du_parts, dstate_in, N,
                            S, H, G, stream);
  return launch<bf16, K>(r, k, v, logw, u, states, d_o, dstate_out, dr, dk,
                         dv, dlogw, du, ends, du_parts, dstate_in, N, S, H, G,
                         stream);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 for r, k, v, u, do, dr, dk, dv, du. r, k, v,
// logw, do, dr, dk, dv, dlogw: (N, S, H, K) contiguous, 8-byte aligned; u,
// du: (G, H, K) with G dividing N; states: (N, H, ceil(S / 64), K, K) f32
// from the forward kernel; dstate_out: (N, H, K, K) f32 or null (zeros);
// ends: (N, H, ceil(S / 64), K, K) f32 and du_parts: (N, H, ceil(S / 64),
// K) f32, scratch; dstate_in: (N, H, K, K) f32 or null (not written). K =
// V in {16, 32, 64}. Three launches (pass 1, pass 2, the du sum); returns
// the first cudaError_t (0 on success); nothing is synchronized and
// nothing allocated.
int repro_rwkv6_backward(int dtype, int K, const void* r, const void* k,
                         const void* v, const void* logw, const void* u,
                         const void* states, const void* d_o,
                         const void* dstate_out, void* dr, void* dk,
                         void* dv, void* dlogw, void* du, void* ends,
                         void* du_parts, void* dstate_in, long long N, int S,
                         int H, long long G, void* stream) {
  if (N <= 0 || S <= 0 || H <= 0 || G <= 0 || N % G ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16:
      return launch_k<16>(dtype, r, k, v, logw, u, states, d_o, dstate_out,
                          dr, dk, dv, dlogw, du, ends, du_parts, dstate_in, N,
                          S, H, G, s);
    case 32:
      return launch_k<32>(dtype, r, k, v, logw, u, states, d_o, dstate_out,
                          dr, dk, dv, dlogw, du, ends, du_parts, dstate_in, N,
                          S, H, G, s);
    case 64:
      return launch_k<64>(dtype, r, k, v, logw, u, states, d_o, dstate_out,
                          dr, dk, dv, dlogw, du, ends, du_parts, dstate_in, N,
                          S, H, G, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_rwkv6_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
