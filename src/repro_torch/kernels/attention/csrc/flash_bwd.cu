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
// Bound: operations. 10 * hd FLOPs per visible (query head, key) pair
// (4 * hd of the forward recomputed, 6 * hd of the three products); both
// passes recompute S and dP, so they do 14 * hd (16 * hd at head dim 256,
// whose dk / dv pass computes S and dP twice, see below). Head dims 16, 32,
// 64, 96, 128 and 256, the forward's: the head dim is a template parameter
// of every kernel, and the wrapper raises on others.
//
// Deterministic: no float atomics. Two passes, each output written by one
// CTA that sums in a fixed order; the wrapper picks each pass's form, grid
// and CTA size (flash_bwd.launch_geometry) and passes them in, and this file
// checks them:
//   (a) dq: one CTA per (batch, kv head, row tile), a loop over the key
//       tiles it may see: S = q k^T, dP = do v^T, dS = p (dP - D),
//       dq += dS k. It also computes D for its rows (from do and o, before
//       the loop) and writes it, which (b) reads after it on the same
//       stream (bf16: with 1 / max(l, 1e-30) beside it). Row tiles run
//       last first: under a causal mask the latest rows see the most
//       keys, so the heaviest CTAs start first.
//   (b) dk / dv: one CTA per (batch, kv head, key tile), a loop over the
//       G * Sq query rows of the kv head in position order: dv += p^T do,
//       dk += dS^T q. The GQA sum over the group runs inside the loop. Key
//       tiles run first to last: the earliest keys are seen by the most
//       rows.
// A (row tile, key tile) pair is skipped when the tiles' position bounds
// show no visible pair (the live tiles of a CTA are listed before its loop,
// so the loop starts at the first row tile that can see its keys); (b)
// keeps a row tile that holds a row which sees no key (its dv term covers
// every key). Tiles that every pair of the CTA sees skip the mask.
//
// bf16: tensor cores (mma.sync.m16n8k16, f32 accumulators: HMMA). Each
// warp owns 16 rows (a) or 16 keys (b) and keeps their 16 x hd f32
// accumulators in registers (dq: hd / 2 a thread; dk and dv: hd). What it
// streams comes by cp.async (16 bytes a thread, zero-filled past the ragged
// edge) into a ring of 64-key or 64-row bf16 tiles (three stages for CTAs
// of 8 warps, two for 4; 32 and two at head dim 256), tiles ahead loading
// while one computes: K, V and key positions in (a); Q, dO and the rows' m, 1 /
// max(l, 1e-30), D and positions in (b). (a) writes 1 / max(l, 1e-30)
// beside D (the second half of the delta scratch), so that (b) divides
// nothing in its loop. The owned side (Q and dO in (a), K and V in (b)) is
// loaded once into shared memory too. Up to head dim 128, (a) holds its
// warp's Q and dO A fragments in registers for the whole loop (hd / 2 of
// them); (b) has no room for K's and V's beside its accumulators and
// reloads them by ldmatrix at each step, as it does every streamed
// fragment. Row pitches of hd + 8 elements keep ldmatrix free of bank
// conflicts at every head dim. Both passes compute in steps of 32 keys (a)
// or 32 rows (b), one step at a time: 32 score registers beside the
// accumulators (ptxas: about 248 registers in (a), 250 in (b) at hd 128, no
// spill; steps of 64 spill, steps of 16 are slower:
// tools/flash_bwd_variants.py). (b) computes S^T and dP^T, keys as the mma
// rows, so that P^T and dS^T are already the A operand of dv and dk. P and
// dS are rounded to bf16 only as mma operands, passed register to register
// from the accumulator layout into the A-fragment layout, as the forward
// passes P; m, l, D and every accumulator stay f32; p is 2^x on the SFU
// (ex2.approx). Q^T / dO^T (for dk, dv) and K^T (for dq) come by
// ldmatrix.trans. A head dim of 16 has one 16-wide k-step, so the paired
// k-steps end in a single one (ldmatrix.x2 for its B fragment) wherever hd
// / 16 is odd. CTAs of 8 warps (128 rows or keys) where the grid still fills
// the 132 SMs, one to an SM; else 4 warps (else 2, see below).
//
// Head dim 256 (gemma3) in bf16, where the registers above would not fit:
//   - the ring holds 32 keys or rows a stage, two stages (a 64 x 264 bf16
//     tile is 33 KB);
//   - (a) keeps its 128 dq accumulators and reloads the Q and dO A fragments
//     from shared memory at every k-step instead of holding 128 more (its
//     k-step loop rolled: unrolled, ptxas spilled). 132 KB with 4 warps,
//     198 KB with 8;
//   - (b) splits the head dim between two warps that share each 16-key
//     tile: both compute S^T and dP^T in full (over all 256 dims), and each
//     holds dk and dv for its own 128 columns (128 accumulators, as at hd
//     128). A CTA of NW warps owns 8 * NW keys; NW = 2 (84 KB, two CTAs an
//     SM) is what fills the card at gemma3's 1-PE shape (4 x 1,024 keys of
//     one kv head: 256 CTAs), 8 warps take 133 KB.
//
// What holds it back, as far as its instruction mix shows (no hardware
// counters were read): each warp shares each streamed fragment with only 16
// mma rows, and (b) reloads its K / V fragments at every step, about 0.6
// ldmatrix.x4 per mma; the scalar work per score (exp, masks, selects)
// competes with them for issue slots, two warps a scheduler leaving little
// to hide latency; and the dq pass recomputes S and dP (14 x hd FLOPs a
// pair in all, not 10). wgmma on 64-row warpgroup tiles is the next step.
//
// f32: CUDA cores (TF32 would break the 1e-4 f32 gates), the first design,
// kept: 256 threads, each holding a (T / 16) x (T / 16) block of the T x T
// score tile and a (T / 16) x (hd / 16) block of its T x hd output tile,
// with the tiles in f32 shared memory padded so that no access conflicts on
// a bank. T = 64 up to head dim 128; 32 at 256, where four 64 x 257 f32
// tiles (263 KB) would not fit in shared memory.
//
// The partial form (a run-time flag, one branch before each dq pass's key
// loop): the backward of the forward's partial (acc, m, l) with m held
// fixed, from the cotangents dacc and dl. p = exp(s - m) (1 / l taken as 1;
// a row that sees no key has m = -1e30 and p = 1 on every key), ds = p
// (dacc v^T + dl): the full form's arithmetic with do = dacc, D = -dl and
// l = 1. The wrapper puts -dl and 1 into the delta scratch, and the dq pass
// reads D where the full form computes and writes it. Exact for a loss
// that sees (acc, m, l) only through acc e^m and l e^m (ring attention's
// merge): the total derivative through m is zero there. A row whose dacc
// and dl are 0 (a wholly masked ring hop's) still costs its tile loop.
//
// Registers, shared memory and spills of every instance (ptxas, printed by
// chip_smoke.py's build phase): see PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;   // shared memory a CTA may have (bytes)
// f32 passes
constexpr int kThreads = 256;      // 16 x 16, thread (a, b)
// bf16 passes
constexpr int kStepQ = 32;         // (a): keys of one compute step
constexpr int kStepKV = 32;        // (b): rows of one compute step
constexpr int kMaxList = 1024;     // tiles listed at a time
constexpr int kHoldMaxHD = 128;    // (a) holds Q / dO fragments up to this hd
// the bf16 kernels' static shared memory: the tile list and four ints
constexpr int kStaticSmem = (kMaxList + 4) * 4;

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
  if (window > 0 && (long long)qmin - kmax >= window) return false;
  return true;
}

// whether every pair of the ranges is visible (keys all at positions >= 0)
__device__ __forceinline__ bool sees_all(int qmin, int qmax, int kmin,
                                         int kmax, int causal, int window) {
  return kmin >= 0 && (!causal || kmax <= qmin) &&
         (window <= 0 || (long long)qmax - kmin < window);
}

struct Shape {
  int Sq, Sk, H, KV, causal, window;
  float scale;
  int partial;   // the partial form: D = -dl comes in the delta scratch
};

// Row r of kv head kvh (r < G * Sq): position r / G of query head
// kvh * G + r % G. Offsets of its q / o / do row and of its stats.
template <int HD>
__device__ __forceinline__ size_t qrow(const Shape& s, int b, int kvh, int r) {
  const int G = s.H / s.KV;
  return ((size_t)(b * s.Sq + r / G) * s.H + kvh * G + r % G) * HD;
}
__device__ __forceinline__ size_t stat_row(const Shape& s, int b, int kvh,
                                           int r) {
  const int G = s.H / s.KV;
  return (size_t)(b * s.H + kvh * G + r % G) * s.Sq + r / G;
}

// ---------------------------------------------------- f32, CUDA cores
// T: rows of a query tile and keys of a key tile
template <int HD>
struct F32Layout {
  static constexpr int T = HD <= 128 ? 64 : 32;
  static constexpr int LD = HD + 1;       // pitch of a T x hd tile
  static constexpr int LDS = T + 16;      // pitch of a T x T tile
  static constexpr int DQ_SMEM = (4 * T * LD + T * LDS + 3 * T) * 4 + 2 * T * 4;
  static constexpr int DKDV_SMEM =
      (4 * T * LD + 2 * T * LDS + 3 * T) * 4 + 2 * T * 4;
};

// (a) dq and D. grid = (B * KV, ceil(G * Sq / T)), block 256; row tiles
// last first.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, float* __restrict__ dq,
                    float* __restrict__ delta, Shape s) {
  using F = F32Layout<HD>;
  constexpr int T = F::T, LD = F::LD, LDS = F::LDS;
  constexpr int TI = T / 16, DIMS = HD / 16;   // a thread's rows, dims
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                       // [T][LD], q * scale
  float* dOs = Qs + T * LD;             // [T][LD]
  float* Ks = dOs + T * LD;             // [T][LD]
  float* Vs = Ks + T * LD;              // [T][LD]
  float* dSs = Vs + T * LD;             // [T][LDS]
  float* mr = dSs + T * LDS;            // [T] row max
  float* li = mr + T;                   // [T] 1 / max(l, 1e-30)
  float* Dr = li + T;                   // [T] rowsum(do * o)
  int* qp = reinterpret_cast<int*>(Dr + T);  // [T]
  int* kp = qp + T;                           // [T]
  __shared__ int bounds[4];             // qmin, qmax, kmin, kmax

  const int G = s.H / s.KV, R = s.Sq * G;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * T;
  const int t = threadIdx.x, ta = t / 16, tb = t % 16;
  const int warp = t / 32, lane = t % 32;

  if (t == 0) {
    bounds[0] = 0x7fffffff;
    bounds[1] = -0x7fffffff - 1;
  }
  for (int e = t; e < T * HD; e += kThreads) {
    const int rr = e / HD, d = e % HD, r = row0 + rr;
    float qv = 0.f, dv = 0.f;
    if (r < R) {
      const size_t off = qrow<HD>(s, b, kvh, r) + d;
      qv = q[off] * s.scale;
      dv = dout[off];
    }
    Qs[rr * LD + d] = qv;
    dOs[rr * LD + d] = dv;
  }
  __syncthreads();
  if (t < T) {
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
  // D: warp w sums rows w T / 8 .. (w + 1) T / 8 - 1, lane over the head
  // dim; the partial form reads it instead (o is not read)
  for (int i = 0; i < T / 8; ++i) {
    const int rr = warp * (T / 8) + i, r = row0 + rr;
    if (s.partial) {
      if (lane == 0) Dr[rr] = r < R ? delta[stat_row(s, b, kvh, r)] : 0.f;
      continue;
    }
    float acc = 0.f;
    if (r < R) {
      const size_t off = qrow<HD>(s, b, kvh, r);
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(dOs[rr * LD + d], o[off + d], acc);
    }
    for (int w = 16; w > 0; w >>= 1)
      acc += __shfl_xor_sync(kFull, acc, w);
    if (lane == 0) {
      Dr[rr] = acc;
      if (r < R) delta[stat_row(s, b, kvh, r)] = acc;
    }
  }
  __syncthreads();
  const int qmin = bounds[0], qmax = bounds[1];

  float acc[TI][DIMS];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < DIMS; ++j) acc[i][j] = 0.f;

  const size_t kv_row = (size_t)s.KV * HD;
  const float* kb = k + ((size_t)b * s.Sk * s.KV + kvh) * HD;
  const float* vb = v + ((size_t)b * s.Sk * s.KV + kvh) * HD;
  for (int k0 = 0; k0 < s.Sk; k0 += T) {
    __syncthreads();   // the previous tile is consumed
    if (t == 0) {
      bounds[2] = 0x7fffffff;
      bounds[3] = -0x7fffffff - 1;
    }
    __syncthreads();
    if (t < T) {
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
    for (int e = t; e < T * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, c = k0 + j;
      const bool ok = c < s.Sk;
      Ks[j * LD + d] = ok ? kb[(size_t)c * kv_row + d] : 0.f;
      Vs[j * LD + d] = ok ? vb[(size_t)c * kv_row + d] : 0.f;
    }
    __syncthreads();
    float sc[TI][TI], dp[TI][TI];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[TI], da[TI], kb4[TI], vb4[TI];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        qa[i] = Qs[(ta + 16 * i) * LD + d];
        da[i] = dOs[(ta + 16 * i) * LD + d];
        kb4[i] = Ks[(tb + 16 * i) * LD + d];
        vb4[i] = Vs[(tb + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j) {
          sc[i][j] = fmaf(qa[i], kb4[j], sc[i][j]);
          dp[i][j] = fmaf(da[i], vb4[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int rr = ta + 16 * i;
      const bool row_ok = row0 + rr < R;
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        const int cc = tb + 16 * j;
        const bool vis = row_ok && k0 + cc < s.Sk &&
                         visible(qp[rr], kp[cc], s.causal, s.window);
        const float p = vis ? expf(sc[i][j] - mr[rr]) * li[rr] : 0.f;
        dSs[rr * LDS + cc] = vis ? p * (dp[i][j] - Dr[rr]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float kc[DIMS];
#pragma unroll
      for (int j = 0; j < DIMS; ++j) kc[j] = Ks[c * LD + tb + 16 * j];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const float ds = dSs[(ta + 16 * i) * LDS + c];
#pragma unroll
        for (int j = 0; j < DIMS; ++j) acc[i][j] = fmaf(ds, kc[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int r = row0 + ta + 16 * i;
    if (r >= R) continue;
    const size_t off = qrow<HD>(s, b, kvh, r);
#pragma unroll
    for (int j = 0; j < DIMS; ++j)
      dq[off + tb + 16 * j] = acc[i][j] * s.scale;
  }
}

// (b) dk and dv. grid = (B * KV, ceil(Sk / T)), block 256.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ m_in,
                      const float* __restrict__ l_in,
                      const float* __restrict__ delta,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ k_pos, float* __restrict__ dk,
                      float* __restrict__ dv, Shape s) {
  using F = F32Layout<HD>;
  constexpr int T = F::T, LD = F::LD, LDS = F::LDS;
  constexpr int TI = T / 16, DIMS = HD / 16;   // a thread's keys, dims
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                       // [T][LD]
  float* Vs = Ks + T * LD;              // [T][LD]
  float* Qs = Vs + T * LD;              // [T][LD], q * scale
  float* dOs = Qs + T * LD;             // [T][LD]
  float* Ps = dOs + T * LD;             // [T rows][LDS]
  float* dSs = Ps + T * LDS;            // [T rows][LDS]
  float* mr = dSs + T * LDS;            // [T]
  float* li = mr + T;                   // [T]
  float* Dr = li + T;                   // [T]
  int* qp = reinterpret_cast<int*>(Dr + T);  // [T]
  int* kp = qp + T;                           // [T]
  __shared__ int bounds[4];             // kmin, kmax, qmin, qmax

  const int G = s.H / s.KV, R = s.Sq * G;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int k0 = blockIdx.y * T;
  const int t = threadIdx.x, ta = t / 16, tb = t % 16;

  const size_t kv_row = (size_t)s.KV * HD;
  const float* kb = k + ((size_t)b * s.Sk * s.KV + kvh) * HD;
  const float* vb = v + ((size_t)b * s.Sk * s.KV + kvh) * HD;
  if (t == 0) {
    bounds[0] = 0x7fffffff;
    bounds[1] = -0x7fffffff - 1;
  }
  for (int e = t; e < T * HD; e += kThreads) {
    const int j = e / HD, d = e % HD, c = k0 + j;
    const bool ok = c < s.Sk;
    Ks[j * LD + d] = ok ? kb[(size_t)c * kv_row + d] : 0.f;
    Vs[j * LD + d] = ok ? vb[(size_t)c * kv_row + d] : 0.f;
  }
  __syncthreads();
  if (t < T) {
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
  float gk[TI][DIMS], gv[TI][DIMS];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < DIMS; ++j) gk[i][j] = gv[i][j] = 0.f;

  for (int row0 = 0; row0 < R; row0 += T) {
    __syncthreads();   // the previous row tile is consumed
    if (t == 0) {
      bounds[2] = 0x7fffffff;
      bounds[3] = -0x7fffffff - 1;
    }
    __syncthreads();
    bool dead = false;
    if (t < T) {
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
    for (int e = t; e < T * HD; e += kThreads) {
      const int rr = e / HD, d = e % HD, r = row0 + rr;
      float qv = 0.f, dv2 = 0.f;
      if (r < R) {
        const size_t off = qrow<HD>(s, b, kvh, r) + d;
        qv = q[off] * s.scale;
        dv2 = dout[off];
      }
      Qs[rr * LD + d] = qv;
      dOs[rr * LD + d] = dv2;
    }
    __syncthreads();
    // thread (ta, tb) scores rows ta + 16 i against keys tb + 16 j
    float sc[TI][TI], dp[TI][TI];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[TI], da[TI], kb4[TI], vb4[TI];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        qa[i] = Qs[(ta + 16 * i) * LD + d];
        da[i] = dOs[(ta + 16 * i) * LD + d];
        kb4[i] = Ks[(tb + 16 * i) * LD + d];
        vb4[i] = Vs[(tb + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j) {
          sc[i][j] = fmaf(qa[i], kb4[j], sc[i][j]);
          dp[i][j] = fmaf(da[i], vb4[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int rr = ta + 16 * i;
      const bool row_ok = row0 + rr < R;
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        const int cc = tb + 16 * j;
        const bool key_ok = row_ok && k0 + cc < s.Sk;
        const bool vis =
            key_ok && visible(qp[rr], kp[cc], s.causal, s.window);
        // a masked score is -1e30: p = 0, or 1 / Sk on a row that sees
        // no key (m = -1e30)
        const float p =
            key_ok ? expf((vis ? sc[i][j] : kNegInf) - mr[rr]) * li[rr] : 0.f;
        Ps[rr * LDS + cc] = p;
        dSs[rr * LDS + cc] = vis ? p * (dp[i][j] - Dr[rr]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < T; ++r) {
      float dor[DIMS], qr[DIMS];
#pragma unroll
      for (int j = 0; j < DIMS; ++j) {
        dor[j] = dOs[r * LD + tb + 16 * j];
        qr[j] = Qs[r * LD + tb + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const float p = Ps[r * LDS + ta + 16 * i];
        const float ds = dSs[r * LDS + ta + 16 * i];
#pragma unroll
        for (int j = 0; j < DIMS; ++j) {
          gv[i][j] = fmaf(p, dor[j], gv[i][j]);
          gk[i][j] = fmaf(ds, qr[j], gk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int c = k0 + ta + 16 * i;
    if (c >= s.Sk) continue;
    const size_t off = ((size_t)(b * s.Sk + c) * s.KV + kvh) * HD;
#pragma unroll
    for (int j = 0; j < DIMS; ++j) {
      dk[off + tb + 16 * j] = gk[i][j];
      dv[off + tb + 16 * j] = gv[i][j];
    }
  }
}

// ------------------------------------------------ bf16, tensor cores
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// the first two matrices of ldmatrix_x4 (lanes 0-15 give the addresses)
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the SFU alone (ex2.approx.ftz: 2 ulp, subnormal results flushed
// to 0), for p in the bf16 passes; exp2f adds range handling around it
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cp.async: 16 or 4 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A CTA of NW warps at head dim HD owns DQ_OWN rows (a) or KV_OWN keys (b)
// and streams the other side through a ring of STAGES tiles of STREAM.
// Bytes of dynamic shared memory (flash_bwd.launch_geometry computes the
// same); FITS_* says whether a pass of this geometry fits beside the static
// shared memory, and only those are launched.
template <int HD, int NW>
struct MmaLayout {
  static constexpr int LDB = HD + 8;                 // row pitch (elements)
  static constexpr int CHUNKS = HD / 8;              // 16-byte pieces a row
  static constexpr int SPLIT = HD > 128 ? 2 : 1;     // (b): warps a key tile
  static constexpr int DQ_OWN = 16 * NW;
  static constexpr int KV_OWN = 16 * NW / SPLIT;
  static constexpr int STAGES = NW == 8 && HD <= 128 ? 3 : 2;
  // keys (a) or rows (b) a ring stage holds
  static constexpr int STREAM = HD <= 128 ? 64 : 32;
  static constexpr int TILE = STREAM * LDB * 2;      // one bf16 tile
  // (a): K, V and key positions; (b): Q, dO and the rows' m, 1 / max(l,
  // 1e-30), D and positions
  static constexpr int DQ_STAGE = 2 * TILE + STREAM * 4;
  static constexpr int DKDV_STAGE = 2 * TILE + 4 * STREAM * 4;
  static constexpr int DQ_SMEM = 2 * DQ_OWN * LDB * 2 + STAGES * DQ_STAGE;
  static constexpr int DKDV_SMEM =
      2 * KV_OWN * LDB * 2 + STAGES * DKDV_STAGE + KV_OWN * 4;
  static constexpr bool FITS_DQ = DQ_SMEM + kStaticSmem <= kMaxSmem;
  static constexpr bool FITS_DKDV = DKDV_SMEM + kStaticSmem <= kMaxSmem;
};

// The live tiles of [c0, c1) into list[] as 2 * t + full, and their count;
// scan(t, lane) -> (live, full) is warp-uniform. Ends with a barrier.
template <typename Scan>
__device__ __forceinline__ int list_tiles(int c0, int c1, int nw, int warp,
                                          int lane, int* list, int* n_live,
                                          Scan scan) {
  for (int t = c0 + warp; t < c1; t += nw) {
    const int2 lf = scan(t, lane);
    if (lane == 0) list[t - c0] = lf.x ? 1 + lf.y : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = c0; t < c1; ++t)
      if (list[t - c0]) list[n++] = 2 * t + (list[t - c0] - 1);
    *n_live = n;
  }
  __syncthreads();
  return *n_live;
}

// acc[j] += A (16 x hd, the A fragments a(kk)) . B^T over hd for the 8-row
// blocks j < NJ of a step whose rows start at `bp` (B fragments by
// ldmatrix, non-transposed); k-steps in pairs, the last one alone where
// hd / 16 is odd. a(kk, frag) fills the A fragment of k-step kk. ROLLED
// keeps the k-step loop rolled (hd / 16 even), for a caller whose A
// fragments come from shared memory and whose registers are all but full.
template <int HD, int LDB, int NJ, bool ROLLED = false, typename AFrag>
__device__ __forceinline__ void scores(float (*acc)[4], const bf16* bp,
                                       int b_off, AFrag a) {
  constexpr int KS = HD / 16;
  static_assert(!ROLLED || KS % 2 == 0, "a rolled loop takes k-step pairs");
  const auto step = [&](int kk) {
    uint32_t a0[4], a1[4];
    a(kk, a0);
    if (kk + 1 < KS) a(kk + 1, a1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bb[4];
      if (kk + 1 < KS) {
        ldmatrix_x4(bb, bp + 8 * j * LDB + b_off + 16 * kk);
        mma16816(acc[j], a0, bb[0], bb[1]);
        mma16816(acc[j], a1, bb[2], bb[3]);
      } else {
        ldmatrix_x2(bb, bp + 8 * j * LDB + b_off + 16 * kk);
        mma16816(acc[j], a0, bb[0], bb[1]);
      }
    }
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int kk = 0; kk < KS; kk += 2) step(kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) step(kk);
  }
}

// (a) dq and D. grid = (B * KV, ceil(G * Sq / (16 * NW))), block 32 * NW,
// dynamic shared memory MmaLayout<HD, NW>::DQ_SMEM; row tiles last first.
template <int HD, int NW>
__global__ void __launch_bounds__(32 * NW, 8 / NW)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos, bf16* __restrict__ dq,
                        float* __restrict__ delta, float* __restrict__ linv,
                        Shape s) {
  using L = MmaLayout<HD, NW>;
  constexpr int RT = L::DQ_OWN, ST = L::STAGES, LDB = L::LDB;
  constexpr int CHUNKS = L::CHUNKS, KS = HD / 16, SM = L::STREAM;
  constexpr bool kHold = HD <= kHoldMaxHD;   // Q / dO fragments held
  // reloading them: the k-step loop rolled where the steps pair up
  constexpr bool kRolled = !kHold && KS % 2 == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);       // [RT][LDB]
  bf16* dos = qs + RT * LDB;                      // [RT][LDB]
  unsigned char* ring = smem + 2 * RT * LDB * 2;  // [ST] x (K, V, positions)
  __shared__ int list[kMaxList];
  __shared__ int n_live_s, qmin_s, qmax_s, rows_ok_s;

  const int G = s.H / s.KV, R = s.Sq * G;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * RT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qlane = lane % 4;

  // the CTA's Q and dO rows: the first commit group
  for (int e = threadIdx.x; e < RT * CHUNKS; e += blockDim.x) {
    const int i = e / CHUNKS, c = e % CHUNKS, r = row0 + i;
    const bool ok = r < R;
    const size_t off = ok ? qrow<HD>(s, b, kvh, r) + c * 8 : 0;
    cp_async16(qs + i * LDB + c * 8, q + off, ok);
    cp_async16(dos + i * LDB + c * 8, dout + off, ok);
  }
  cp_async_commit();
  if (threadIdx.x == 0) {
    qmin_s = 0x7fffffff;
    qmax_s = -0x7fffffff - 1;
    rows_ok_s = row0 + RT <= R;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RT; i += blockDim.x) {
    const int r = row0 + i;
    if (r < R) {
      const int p = q_pos[(size_t)b * s.Sq + r / G];
      atomicMin(&qmin_s, p);
      atomicMax(&qmax_s, p);
    }
  }

  // this thread's rows r0 and r1 = r0 + 8: position, m log2(e),
  // 1 / max(l, 1e-30), and D, which the warp sums over its 16 rows (lanes
  // over the head dim, 4 elements at a time) and writes; the partial form
  // reads D and writes nothing (its 1 / l, 1, is in the scratch already)
  const int r0 = row0 + warp * 16 + quad, r1 = r0 + 8;
  const bool ok0 = r0 < R, ok1 = r1 < R;
  const int qp0 = ok0 ? q_pos[(size_t)b * s.Sq + r0 / G] : 0;
  const int qp1 = ok1 ? q_pos[(size_t)b * s.Sq + r1 / G] : 0;
  const float ml0 = ok0 ? m_in[stat_row(s, b, kvh, r0)] * kLog2e : 0.f;
  const float ml1 = ok1 ? m_in[stat_row(s, b, kvh, r1)] * kLog2e : 0.f;
  const float li0 =
      ok0 ? 1.f / fmaxf(l_in[stat_row(s, b, kvh, r0)], 1e-30f) : 0.f;
  const float li1 =
      ok1 ? 1.f / fmaxf(l_in[stat_row(s, b, kvh, r1)], 1e-30f) : 0.f;
  float D0 = 0.f, D1 = 0.f;
  if (s.partial) {
    D0 = ok0 ? delta[stat_row(s, b, kvh, r0)] : 0.f;
    D1 = ok1 ? delta[stat_row(s, b, kvh, r1)] : 0.f;
  }
  for (int i = 0; i < 16 && !s.partial; ++i) {
    const int r = row0 + warp * 16 + i;
    float acc = 0.f;
    if (r < R) {
      for (int d0 = 4 * lane; d0 < HD; d0 += 128) {
        const size_t off = qrow<HD>(s, b, kvh, r) + d0;
        const uint2 a = *reinterpret_cast<const uint2*>(dout + off);
        const uint2 c = *reinterpret_cast<const uint2*>(o + off);
        const float2 a0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&a.x));
        const float2 a1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&a.y));
        const float2 c0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&c.x));
        const float2 c1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&c.y));
        acc += a0.x * c0.x + a0.y * c0.y + a1.x * c1.x + a1.y * c1.y;
      }
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(kFull, acc, w);
    if (i == quad) D0 = acc;
    if (i == quad + 8) D1 = acc;
    if (lane == 0 && r < R) {
      const size_t so = stat_row(s, b, kvh, r);
      delta[so] = acc;
      linv[so] = 1.f / fmaxf(l_in[so], 1e-30f);
    }
  }
  __syncthreads();
  const int qmin = qmin_s, qmax = qmax_s;
  const bool rows_ok = rows_ok_s;

  const size_t kv_row = (size_t)s.KV * HD;
  const bf16* kb = k + ((size_t)b * s.Sk * s.KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * s.Sk * s.KV + kvh) * HD;
  const int* kpb = k_pos + (size_t)b * s.Sk;
  const auto stage_k = [&](int st) {
    return reinterpret_cast<bf16*>(ring + st * L::DQ_STAGE);
  };
  const auto load_tile = [&](int t, int st) {
    bf16* kd = stage_k(st);
    bf16* vd = kd + SM * LDB;
    int* pd = reinterpret_cast<int*>(vd + SM * LDB);
    for (int e = threadIdx.x; e < SM * CHUNKS; e += blockDim.x) {
      const int j = e / CHUNKS, c = e % CHUNKS, sk = t * SM + j;
      const bool ok = sk < s.Sk;
      const size_t off = (size_t)(ok ? sk : 0) * kv_row + c * 8;
      cp_async16(kd + j * LDB + c * 8, kb + off, ok);
      cp_async16(vd + j * LDB + c * 8, vb + off, ok);
    }
    for (int j = threadIdx.x; j < SM; j += blockDim.x) {
      const int sk = t * SM + j;
      cp_async4(pd + j, kpb + (sk < s.Sk ? sk : 0), sk < s.Sk);
    }
  };
  const auto scan = [&](int t, int ln) -> int2 {
    int kmin = 0x7fffffff, kmax = -1, lo = 0x7fffffff, gone = 0;
#pragma unroll
    for (int h = 0; h < SM / 32; ++h) {
      const int sk = t * SM + h * 32 + ln;
      if (sk < s.Sk) {
        const int p = kpb[sk];
        lo = min(lo, p);
        if (p >= 0) {
          kmin = min(kmin, p);
          kmax = max(kmax, p);
        }
      } else {
        gone = 1;
      }
    }
    kmin = __reduce_min_sync(kFull, kmin);
    kmax = __reduce_max_sync(kFull, kmax);
    lo = __reduce_min_sync(kFull, lo);
    gone = __reduce_or_sync(kFull, gone);
    const bool live = may_see(qmin, qmax, kmin, kmax, s.causal, s.window);
    const bool full = rows_ok && !gone && lo >= 0 &&
                      sees_all(qmin, qmax, kmin, kmax, s.causal, s.window);
    return make_int2(live, full);
  };

  const float sl2 = s.scale * kLog2e;
  // ldmatrix addresses: A fragments of the warp's Q / dO rows; B fragments
  // of K / V rows (non-transposed); K^T fragments (transposed)
  const bf16* qa_p = qs + (warp * 16 + (lane & 15)) * LDB + 8 * (lane >> 4);
  const bf16* da_p = dos + (warp * 16 + (lane & 15)) * LDB + 8 * (lane >> 4);
  const int b_off = (lane & 7) * LDB + 8 * (lane >> 3);
  const int t_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                    8 * (lane >> 4);
  float acc[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  cp_async_wait<0>();   // Q and dO: the only group in flight
  __syncthreads();
  // up to kHoldMaxHD: the warp's Q and dO A fragments, held for the whole
  // loop; above it, reloaded from shared memory at each k-step
  uint32_t qf[kHold ? KS : 1][4], df[kHold ? KS : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(qf[kk], qa_p + 16 * kk);
      ldmatrix_x4(df[kk], da_p + 16 * kk);
    }
  }
  const auto q_frag = [&](int kk, uint32_t* a) {
    if constexpr (kHold) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
    } else {
      ldmatrix_x4(a, qa_p + 16 * kk);
    }
  };
  const auto do_frag = [&](int kk, uint32_t* a) {
    if constexpr (kHold) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = df[kk][e];
    } else {
      ldmatrix_x4(a, da_p + 16 * kk);
    }
  };

  const int n_tiles = (s.Sk + SM - 1) / SM;
  for (int c0 = 0; c0 < n_tiles; c0 += kMaxList) {
    const int n_live = list_tiles(c0, min(n_tiles, c0 + kMaxList), NW, warp,
                                  lane, list, &n_live_s, scan);
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (i < n_live) load_tile(list[i] / 2, i);
      cp_async_commit();
    }
    for (int i = 0; i < n_live; ++i) {
      const int t = list[i] / 2, st = i % ST;
      const bool full = list[i] & 1;
      cp_async_wait<ST - 2>();   // tile i has landed
      __syncthreads();           // ... for every thread; tile i - 1 consumed
      if (i + ST - 1 < n_live)
        load_tile(list[i + ST - 1] / 2, (i + ST - 1) % ST);
      cp_async_commit();
      const bf16* kt = stage_k(st);
      const bf16* vt = kt + SM * LDB;
      const int* kpt = reinterpret_cast<const int*>(vt + SM * LDB);

      // in halves of 32 keys (kept apart: 32 score registers beside the
      // accumulators)
#pragma unroll 1
      for (int h = 0; h < SM / kStepQ; ++h) {
        float sc[kStepQ / 8][4], dp[kStepQ / 8][4];
#pragma unroll
        for (int j = 0; j < kStepQ / 8; ++j)
          sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = dp[j][0] = dp[j][1] =
              dp[j][2] = dp[j][3] = 0.f;
        const bf16* kh = kt + kStepQ * h * LDB;
        const bf16* vh = vt + kStepQ * h * LDB;
        scores<HD, LDB, kStepQ / 8, kRolled>(sc, kh, b_off, q_frag);
        scores<HD, LDB, kStepQ / 8, kRolled>(dp, vh, b_off, do_frag);
        // dS = p (dP - D) on visible pairs, in place of dP
#pragma unroll
        for (int j = 0; j < kStepQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool lo_row = e < 2;
            const float p =
                ex2(fmaf(sc[j][e], sl2, -(lo_row ? ml0 : ml1))) *
                (lo_row ? li0 : li1);
            bool vis = full;
            if (!full) {   // CTA-uniform
              const int jj = kStepQ * h + 8 * j + 2 * qlane + (e & 1);
              vis = (lo_row ? ok0 : ok1) && t * SM + jj < s.Sk &&
                    visible(lo_row ? qp0 : qp1, kpt[jj], s.causal, s.window);
            }
            dp[j][e] = vis ? p * (dp[j][e] - (lo_row ? D0 : D1)) : 0.f;
          }
        }
        // dq += dS k: dS from the accumulators (bf16), K^T by
        // ldmatrix.trans
#pragma unroll
        for (int kt2 = 0; kt2 < kStepQ / 16; ++kt2) {
          uint32_t a[4];
          a[0] = pack_bf16(dp[2 * kt2][0], dp[2 * kt2][1]);
          a[1] = pack_bf16(dp[2 * kt2][2], dp[2 * kt2][3]);
          a[2] = pack_bf16(dp[2 * kt2 + 1][0], dp[2 * kt2 + 1][1]);
          a[3] = pack_bf16(dp[2 * kt2 + 1][2], dp[2 * kt2 + 1][3]);
          const bf16* kr = kh + 16 * kt2 * LDB + t_off;
#pragma unroll
          for (int nb2 = 0; nb2 < HD / 16; ++nb2) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, kr + 16 * nb2);
            mma16816(acc[2 * nb2], a, bk[0], bk[1]);
            mma16816(acc[2 * nb2 + 1], a, bk[2], bk[3]);
          }
        }
      }
    }
    cp_async_wait<0>();   // the empty groups
    __syncthreads();      // the list and the ring are free again
  }

#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    const int c = 8 * nb + 2 * qlane;
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(dq + qrow<HD>(s, b, kvh, r0) + c) =
          __floats2bfloat162_rn(acc[nb][0] * s.scale, acc[nb][1] * s.scale);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(dq + qrow<HD>(s, b, kvh, r1) + c) =
          __floats2bfloat162_rn(acc[nb][2] * s.scale, acc[nb][3] * s.scale);
  }
}

// (b) dk and dv. grid = (B * KV, ceil(Sk / KV_OWN)), block 32 * NW,
// dynamic shared memory MmaLayout<HD, NW>::DKDV_SMEM; key tiles first to
// last. Warp w scores keys 16 (w / SPLIT) .. + 15 over the whole head dim
// and accumulates dk and dv in head-dim columns (w % SPLIT) HD / SPLIT ..
template <int HD, int NW>
__global__ void __launch_bounds__(32 * NW, 8 / NW)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ m_in,
                          const float* __restrict__ linv,
                          const float* __restrict__ delta,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          Shape s) {
  using L = MmaLayout<HD, NW>;
  constexpr int KT = L::KV_OWN, ST = L::STAGES, LDB = L::LDB;
  constexpr int CHUNKS = L::CHUNKS, KS = HD / 16, DC = HD / L::SPLIT;
  constexpr int SM = L::STREAM;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);       // [KT][LDB]
  bf16* vs = ks + KT * LDB;                       // [KT][LDB]
  // [ST] x (Q, dO, m, 1/l, D, pos)
  unsigned char* ring = smem + 2 * KT * LDB * 2;
  int* kps = reinterpret_cast<int*>(ring + ST * L::DKDV_STAGE);  // [KT]
  __shared__ int list[kMaxList];
  __shared__ int n_live_s, kmin_s, kmax_s, keys_ok_s;

  const int G = s.H / s.KV, R = s.Sq * G;
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int k0 = blockIdx.y * KT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qlane = lane % 4;
  const int kw = warp / L::SPLIT;            // the warp's 16-key group
  const int col0 = (warp % L::SPLIT) * DC;   // its first dk / dv column

  // the CTA's K and V: the first commit group
  const size_t kv_row = (size_t)s.KV * HD;
  const bf16* kb = k + ((size_t)b * s.Sk * s.KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * s.Sk * s.KV + kvh) * HD;
  for (int e = threadIdx.x; e < KT * CHUNKS; e += blockDim.x) {
    const int j = e / CHUNKS, c = e % CHUNKS, sk = k0 + j;
    const bool ok = sk < s.Sk;
    const size_t off = (size_t)(ok ? sk : 0) * kv_row + c * 8;
    cp_async16(ks + j * LDB + c * 8, kb + off, ok);
    cp_async16(vs + j * LDB + c * 8, vb + off, ok);
  }
  cp_async_commit();
  if (threadIdx.x == 0) {
    kmin_s = 0x7fffffff;
    kmax_s = -1;
    keys_ok_s = 1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < KT; j += blockDim.x) {
    const int sk = k0 + j;
    const int p = sk < s.Sk ? k_pos[(size_t)b * s.Sk + sk] : -1;
    kps[j] = p;
    if (p < 0) keys_ok_s = 0;
    if (p >= 0) {
      atomicMin(&kmin_s, p);
      atomicMax(&kmax_s, p);
    }
  }
  __syncthreads();
  const int kmin = kmin_s, kmax = kmax_s;
  const bool keys_ok = keys_ok_s;
  // this thread's keys c0 and c1 = c0 + 8 (local): whether they exist, and
  // their positions
  const int c0 = kw * 16 + quad, c1 = c0 + 8;
  const bool kok0 = k0 + c0 < s.Sk, kok1 = k0 + c1 < s.Sk;
  const int kp0 = kps[c0], kp1 = kps[c1];

  const int* qpb = q_pos + (size_t)b * s.Sq;
  const auto stage_q = [&](int st) {
    return reinterpret_cast<bf16*>(ring + st * L::DKDV_STAGE);
  };
  const auto load_tile = [&](int t, int st) {
    bf16* qd = stage_q(st);
    bf16* dd = qd + SM * LDB;
    float* md = reinterpret_cast<float*>(dd + SM * LDB);
    float* ld = md + SM;
    float* Dd = ld + SM;
    int* pd = reinterpret_cast<int*>(Dd + SM);
    for (int e = threadIdx.x; e < SM * CHUNKS; e += blockDim.x) {
      const int i = e / CHUNKS, c = e % CHUNKS, r = t * SM + i;
      const bool ok = r < R;
      const size_t off = ok ? qrow<HD>(s, b, kvh, r) + c * 8 : 0;
      cp_async16(qd + i * LDB + c * 8, q + off, ok);
      cp_async16(dd + i * LDB + c * 8, dout + off, ok);
    }
    for (int i = threadIdx.x; i < SM; i += blockDim.x) {
      const int r = t * SM + i;
      const bool ok = r < R;
      const size_t so = ok ? stat_row(s, b, kvh, r) : 0;
      cp_async4(md + i, m_in + so, ok);
      cp_async4(ld + i, linv + so, ok);
      cp_async4(Dd + i, delta + so, ok);
      cp_async4(pd + i, qpb + (ok ? r / G : 0), ok);
    }
  };
  const auto scan = [&](int t, int ln) -> int2 {
    int qmin = 0x7fffffff, qmax = -0x7fffffff - 1, gone = 0, dead = 0;
#pragma unroll
    for (int h = 0; h < SM / 32; ++h) {
      const int r = t * SM + h * 32 + ln;
      if (r < R) {
        const int p = qpb[r / G];
        qmin = min(qmin, p);
        qmax = max(qmax, p);
        dead |= m_in[stat_row(s, b, kvh, r)] <= 0.5f * kNegInf;
      } else {
        gone = 1;
      }
    }
    qmin = __reduce_min_sync(kFull, qmin);
    qmax = __reduce_max_sync(kFull, qmax);
    gone = __reduce_or_sync(kFull, gone);
    dead = __reduce_or_sync(kFull, dead);
    const bool live =
        dead || may_see(qmin, qmax, kmin, kmax, s.causal, s.window);
    const bool full = !gone && !dead && keys_ok &&
                      sees_all(qmin, qmax, kmin, kmax, s.causal, s.window);
    return make_int2(live, full);
  };

  const float sl2 = s.scale * kLog2e;
  // ldmatrix addresses: A fragments of the warp's K / V rows; B fragments
  // of Q / dO rows (non-transposed); Q^T / dO^T fragments (transposed)
  const bf16* ka_p = ks + (kw * 16 + (lane & 15)) * LDB + 8 * (lane >> 4);
  const bf16* va_p = vs + (kw * 16 + (lane & 15)) * LDB + 8 * (lane >> 4);
  const int b_off = (lane & 7) * LDB + 8 * (lane >> 3);
  const int t_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                    8 * (lane >> 4) + col0;
  const auto k_frag = [&](int kk, uint32_t* a) {
    ldmatrix_x4(a, ka_p + 16 * kk);
  };
  const auto v_frag = [&](int kk, uint32_t* a) {
    ldmatrix_x4(a, va_p + 16 * kk);
  };
  float gk[DC / 8][4], gv[DC / 8][4];
#pragma unroll
  for (int nb = 0; nb < DC / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[nb][e] = gv[nb][e] = 0.f;

  const int n_tiles = (R + SM - 1) / SM;
  for (int ch = 0; ch < n_tiles; ch += kMaxList) {
    const int n_live = list_tiles(ch, min(n_tiles, ch + kMaxList), NW, warp,
                                  lane, list, &n_live_s, scan);
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) {
      if (i < n_live) load_tile(list[i] / 2, i);
      cp_async_commit();
    }
    for (int i = 0; i < n_live; ++i) {
      const int t = list[i] / 2, st = i % ST;
      const bool full = list[i] & 1;
      cp_async_wait<ST - 2>();   // tile i (and K, V) have landed
      __syncthreads();           // ... for every thread; tile i - 1 consumed
      if (i + ST - 1 < n_live)
        load_tile(list[i + ST - 1] / 2, (i + ST - 1) % ST);
      cp_async_commit();
      const bf16* qt = stage_q(st);
      const bf16* dt = qt + SM * LDB;
      const float* md = reinterpret_cast<const float*>(dt + SM * LDB);
      const float* ld = md + SM;
      const float* Dd = ld + SM;
      const int* pd = reinterpret_cast<const int*>(Dd + SM);

#pragma unroll 1
      for (int h = 0; h < SM / kStepKV; ++h) {
        // S^T = K Q^T and dP^T = V dO^T for rows 32 h .. 32 h + 31: keys
        // are the mma rows, the tile's rows its columns
        float sc[kStepKV / 8][4], dp[kStepKV / 8][4];
#pragma unroll
        for (int j = 0; j < kStepKV / 8; ++j)
          sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = dp[j][0] = dp[j][1] =
              dp[j][2] = dp[j][3] = 0.f;
        scores<HD, LDB, kStepKV / 8>(sc, qt + kStepKV * h * LDB, b_off,
                                     k_frag);
        scores<HD, LDB, kStepKV / 8>(dp, dt + kStepKV * h * LDB, b_off,
                                     v_frag);
        // P^T in place of S^T, dS^T in place of dP^T. Element e of block
        // j: key c0 (e < 2) or c1, row 32 h + 8 j + 2 qlane + (e & 1). A
        // masked key of a row that sees no key (m = -1e30) has p = 1 / l.
#pragma unroll
        for (int j = 0; j < kStepKV / 8; ++j) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int row = kStepKV * h + 8 * j + 2 * qlane + e2;
            const float m = md[row];
            const float li = ld[row];
            const float D = Dd[row];
            const bool rok = t * SM + row < R;
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int e = 2 * e1 + e2;
              const float p =
                  ex2(fmaf(sc[j][e], sl2, -m * kLog2e)) * li;
              bool vis = full, exists = full;
              if (!full) {   // CTA-uniform
                exists = rok && (e1 ? kok1 : kok0);
                vis = exists &&
                      visible(pd[row], e1 ? kp1 : kp0, s.causal, s.window);
              }
              sc[j][e] = vis ? p
                             : (exists && m <= 0.5f * kNegInf ? li : 0.f);
              dp[j][e] = vis ? p * (dp[j][e] - D) : 0.f;
            }
          }
        }
        // dv += P^T do and dk += dS^T q over the warp's DC columns: the A
        // operand from the accumulators (bf16), dO^T / Q^T by
        // ldmatrix.trans
#pragma unroll
        for (int kt2 = 0; kt2 < kStepKV / 16; ++kt2) {
          uint32_t ap[4], as[4];
          ap[0] = pack_bf16(sc[2 * kt2][0], sc[2 * kt2][1]);
          ap[1] = pack_bf16(sc[2 * kt2][2], sc[2 * kt2][3]);
          ap[2] = pack_bf16(sc[2 * kt2 + 1][0], sc[2 * kt2 + 1][1]);
          ap[3] = pack_bf16(sc[2 * kt2 + 1][2], sc[2 * kt2 + 1][3]);
          as[0] = pack_bf16(dp[2 * kt2][0], dp[2 * kt2][1]);
          as[1] = pack_bf16(dp[2 * kt2][2], dp[2 * kt2][3]);
          as[2] = pack_bf16(dp[2 * kt2 + 1][0], dp[2 * kt2 + 1][1]);
          as[3] = pack_bf16(dp[2 * kt2 + 1][2], dp[2 * kt2 + 1][3]);
          const int ro = (kStepKV * h + 16 * kt2) * LDB + t_off;
#pragma unroll
          for (int nb2 = 0; nb2 < DC / 16; ++nb2) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, dt + ro + 16 * nb2);
            mma16816(gv[2 * nb2], ap, bb[0], bb[1]);
            mma16816(gv[2 * nb2 + 1], ap, bb[2], bb[3]);
            ldmatrix_x4_trans(bb, qt + ro + 16 * nb2);
            mma16816(gk[2 * nb2], as, bb[0], bb[1]);
            mma16816(gk[2 * nb2 + 1], as, bb[2], bb[3]);
          }
        }
      }
    }
    cp_async_wait<0>();   // the empty groups, and K / V if nothing ran
    __syncthreads();      // the list and the ring are free again
  }

  const auto out_row = [&](int c) {
    return ((size_t)(b * s.Sk + k0 + c) * s.KV + kvh) * HD + col0;
  };
#pragma unroll
  for (int nb = 0; nb < DC / 8; ++nb) {
    const int d = 8 * nb + 2 * qlane;
    if (kok0) {
      *reinterpret_cast<__nv_bfloat162*>(dk + out_row(c0) + d) =
          __floats2bfloat162_rn(gk[nb][0] * s.scale, gk[nb][1] * s.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + out_row(c0) + d) =
          __floats2bfloat162_rn(gv[nb][0], gv[nb][1]);
    }
    if (kok1) {
      *reinterpret_cast<__nv_bfloat162*>(dk + out_row(c1) + d) =
          __floats2bfloat162_rn(gk[nb][2] * s.scale, gk[nb][3] * s.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + out_row(c1) + d) =
          __floats2bfloat162_rn(gv[nb][2], gv[nb][3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *m, *l;
  const int *qp, *kp;
  void *dq, *dk, *dv;
  float* delta;
  int B;
};

// the pass's geometry as this file launches it
struct Launch {
  int gy, block, smem;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int HD>
cudaError_t launch_f32(const Args& a, const Shape& s, Launch dq_l,
                       Launch kv_l, cudaStream_t st) {
  using F = F32Layout<HD>;
  const int R = s.Sq * (s.H / s.KV);
  if (dq_l.block != kThreads || kv_l.block != kThreads ||
      dq_l.gy != ceil_div(R, F::T) || kv_l.gy != ceil_div(s.Sk, F::T) ||
      dq_l.smem != F::DQ_SMEM || kv_l.smem != F::DKDV_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::DQ_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           F::DKDV_SMEM);
  if (e != cudaSuccess) return e;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  flash_bwd_dq_kernel<HD><<<dim3(a.B * s.KV, dq_l.gy), kThreads, F::DQ_SMEM,
                            st>>>(q, k, v, static_cast<const float*>(a.o),
                                  static_cast<const float*>(a.dout), a.m, a.l,
                                  a.qp, a.kp, static_cast<float*>(a.dq),
                                  a.delta, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<HD><<<dim3(a.B * s.KV, kv_l.gy), kThreads,
                              F::DKDV_SMEM, st>>>(
      q, k, v, static_cast<const float*>(a.dout), a.m, a.l, a.delta, a.qp,
      a.kp, static_cast<float*>(a.dk), static_cast<float*>(a.dv), s);
  return cudaGetLastError();
}

// 1 / max(l, 1e-30) of every row: the second half of the delta scratch,
// which the bf16 dq pass writes and the dk / dv pass reads
float* linv_of(const Args& a, const Shape& s) {
  return a.delta + (size_t)a.B * s.H * s.Sq;
}

// Whether this file launches a bf16 dk / dv pass of NW warps at HD: 8 or 4
// warps, or 2 where two warps share a 16-key tile; its shared memory fits.
template <int HD, int NW>
constexpr bool kv_launched() {
  using L = MmaLayout<HD, NW>;
  return L::FITS_DKDV && (NW == 8 || NW == 4 || (NW == 2 && L::SPLIT == 2));
}

template <int HD, int NW>
bool kv_geometry_ok(const Shape& s, Launch l) {
  using L = MmaLayout<HD, NW>;
  return kv_launched<HD, NW>() && l.gy == ceil_div(s.Sk, L::KV_OWN) &&
         l.smem == L::DKDV_SMEM;
}

template <int HD, int NW>
cudaError_t launch_dq_mma(const Args& a, const Shape& s, Launch l,
                          cudaStream_t st) {
  using L = MmaLayout<HD, NW>;
  if constexpr (!L::FITS_DQ) {
    return cudaErrorInvalidValue;
  } else {
    const int R = s.Sq * (s.H / s.KV);
    if (l.gy != ceil_div(R, L::DQ_OWN) || l.smem != L::DQ_SMEM)
      return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_mma_kernel<HD, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::DQ_SMEM);
    if (e != cudaSuccess) return e;
    flash_bwd_dq_mma_kernel<HD, NW>
        <<<dim3(a.B * s.KV, l.gy), 32 * NW, L::DQ_SMEM, st>>>(
            static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
            static_cast<const bf16*>(a.dout), a.m, a.l, a.qp, a.kp,
            static_cast<bf16*>(a.dq), a.delta, linv_of(a, s), s);
    return cudaGetLastError();
  }
}

template <int HD, int NW>
cudaError_t launch_dkdv_mma(const Args& a, const Shape& s, Launch l,
                            cudaStream_t st) {
  using L = MmaLayout<HD, NW>;
  if constexpr (!kv_launched<HD, NW>()) {
    return cudaErrorInvalidValue;
  } else {
    if (l.gy != ceil_div(s.Sk, L::KV_OWN) || l.smem != L::DKDV_SMEM)
      return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_mma_kernel<HD, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::DKDV_SMEM);
    if (e != cudaSuccess) return e;
    flash_bwd_dkdv_mma_kernel<HD, NW>
        <<<dim3(a.B * s.KV, l.gy), 32 * NW, L::DKDV_SMEM, st>>>(
            static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
            a.m, linv_of(a, s), a.delta, a.qp, a.kp,
            static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), s);
    return cudaGetLastError();
  }
}

// Both passes at head dim HD; the geometry checked against what this file
// launches for the shape (a bf16 pass of 8 or 4 warps, or 2 in the dk / dv
// pass at head dim 256, whose shared memory fits; or the f32 passes), else
// cudaErrorInvalidValue before any launch.
template <int HD>
cudaError_t launch_hd(int dtype, const Args& a, const Shape& s, Launch dq_l,
                      Launch kv_l, cudaStream_t st) {
  if (dtype == 0) return launch_f32<HD>(a, s, dq_l, kv_l, st);
  if (dq_l.block != 128 && dq_l.block != 256) return cudaErrorInvalidValue;
  // check the dk / dv pass before launching the dq pass
  const bool kv_ok = kv_l.block == 256   ? kv_geometry_ok<HD, 8>(s, kv_l)
                     : kv_l.block == 128 ? kv_geometry_ok<HD, 4>(s, kv_l)
                     : kv_l.block == 64  ? kv_geometry_ok<HD, 2>(s, kv_l)
                                         : false;
  if (!kv_ok) return cudaErrorInvalidValue;
  cudaError_t e = dq_l.block == 256 ? launch_dq_mma<HD, 8>(a, s, dq_l, st)
                                    : launch_dq_mma<HD, 4>(a, s, dq_l, st);
  if (e != cudaSuccess) return e;
  switch (kv_l.block) {
    case 256: return launch_dkdv_mma<HD, 8>(a, s, kv_l, st);
    case 128: return launch_dkdv_mma<HD, 4>(a, s, kv_l, st);
    default: return launch_dkdv_mma<HD, 2>(a, s, kv_l, st);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv share it).
// q, o, do, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Sk, KV, hd); m, l: f32
// (B, H, Sq); delta: f32 scratch of 2 x (B, H, Sq) that this call writes (D
// = rowsum(do * o), then 1 / max(l, 1e-30) in bf16); positions int32
// (B, Sq) / (B, Sk). hd is one of 16, 32, 64, 96, 128, 256. The launch
// geometry of the dq pass and of the dk / dv pass (grid.y, threads a CTA,
// dynamic shared-memory bytes; grid.x is B * KV) comes from
// flash_bwd.launch_geometry and must be one that this file launches for the
// shape: bf16 takes the tensor-core passes (CTAs of 128 or 256 threads whose
// shared memory fits), f32 the CUDA-core ones (256). Two launches on
// `stream`; returns the first cudaError_t that is not cudaSuccess, or 0.
// Nothing is synchronized and nothing is allocated.
// `partial`: the backward of the forward's partial form with m held fixed
// (see the note at the top). The caller fills the delta scratch, -dl then
// 1, and passes the cotangent of acc, in q's layout and dtype, as `dout`, 1
// (the scratch's second half) as `l`, and any pointer as `o`: it is not
// read. Then neither pass writes the scratch.
int repro_flash_attention_backward(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* m,
                                   const void* l, const void* q_pos,
                                   const void* k_pos, void* dq, void* dk,
                                   void* dv, void* delta, int B, int Sq,
                                   int Sk, int H, int KV, int hd, int causal,
                                   int window, float scale, int dq_grid_y,
                                   int dq_block, int dq_smem,
                                   int dkdv_grid_y, int dkdv_block,
                                   int dkdv_smem, int partial,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (dq_grid_y > 65535 || dkdv_grid_y > 65535) return cudaErrorInvalidValue;
  const Shape s{Sq, Sk, H, KV, causal, window, scale, partial != 0};
  const Args a{q,  k,  v,  o,  dout,
               static_cast<const float*>(m), static_cast<const float*>(l),
               static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
               dq, dk, dv, static_cast<float*>(delta), B};
  const Launch dq_l{dq_grid_y, dq_block, dq_smem};
  const Launch kv_l{dkdv_grid_y, dkdv_block, dkdv_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(dtype, a, s, dq_l, kv_l, st);
    case 32: return launch_hd<32>(dtype, a, s, dq_l, kv_l, st);
    case 64: return launch_hd<64>(dtype, a, s, dq_l, kv_l, st);
    case 96: return launch_hd<96>(dtype, a, s, dq_l, kv_l, st);
    case 128: return launch_hd<128>(dtype, a, s, dq_l, kv_l, st);
    case 256: return launch_hd<256>(dtype, a, s, dq_l, kv_l, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
