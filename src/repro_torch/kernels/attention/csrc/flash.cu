// Flash attention for Hopper (sm_90a), CUDA C++ with a plain C interface
// (loaded with ctypes by repro_torch/kernels/attention/flash.py).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention`
// (src/repro/kernels/attention/flash.py): causal / sliding-window GQA
// attention, f32 online softmax, finite NEG_INF = -1e30, output /
// max(l, 1e-30). It also returns the f32 partials (acc, m, l) that
// flash-decode LSE-combines across cache shards, or beside the output the
// row statistics (m, l) alone, which the backward (flash_bwd.cu) reads.
// Positions come from int32 device tensors (query (B, Sq), key (B, Sk)).
// Visibility: k_pos >= 0,
// k_pos <= q_pos when causal, q_pos - k_pos < window when window > 0. A row
// that sees no key averages v over all Sk keys: m = -1e30, l = Sk, acc =
// sum v. A query row is one (position, group member) pair of a kv head, so
// the G query heads of a GQA group share every K/V read.
//
// One call is one launch. The wrapper picks the form and the grid
// (flash.launch_geometry) and passes them in; this file checks them. Head
// dims 16, 32, 64, 96, 128 and 256 (every one the Pallas kernel and the
// repo's configs use), f32 and bf16.
//
// (a) Decode form, Sq * G <= 8 rows per (batch, kv head): every serving
//     decode step (1-2 rows against 6-48 keys, partial). Bound: latency at
//     the serving shapes (a few hundred KB: well under a microsecond of
//     bytes), bytes over long caches. Tensor cores do not help one or two
//     rows. One CTA of 8 warps per (batch, kv head) holds all its rows; the
//     warps split the key range, and within a warp a group of LG lanes
//     holds one key in 16-byte pieces (bf16 hd 128: 16 lanes x 8, two keys
//     per warp step). LG is the key's piece count rounded up to a power of
//     two, at most 32: hd 96 pads 12 (bf16) or 24 (f32) pieces to 16 or 32
//     lanes, the rest idle; f32 hd 256 gives each of 32 lanes 2 pieces
//     (DecodeLayout). Each lane streams its pieces of K and of V (and its
//     key's position) by cp.async into its own ring of 4 warp steps in
//     shared memory (36,864 bytes a CTA; 69,632 at f32 hd 256), 3 steps
//     ahead of the one it scores; it reads back only what it copied, so its
//     own wait_group orders it and no barrier is needed. A shuffle over the
//     lane group reduces each row's score; each lane group keeps its own
//     f32 (m, l, acc) in registers; lane groups merge by shuffles, warps
//     through shared memory (8 x rows x hd f32, in the ring's bytes after
//     the key loop: 64 KB at 8 rows of 256, over the 48 KB of static
//     shared memory, so it is part of the dynamic allocation). Where B *
//     KV is below 132 SMs and the cache is long, the key range is also
//     split over a thread-block cluster of up to 8 CTAs (grid.y), and rank
//     0 merges the others' partials from distributed shared memory: no
//     scratch in device memory, no counter, one launch. f32 takes the same
//     layout. K and V (and the int8 scales) may have a strided lead: row b
//     starts at (b / lead) * kv_c + (b % lead) * kv_b, so decode reads one
//     unit's slice of a cube cache (*cube, units, B, S, KV, hd) where it
//     lies, without a copy; the (S, KV, hd) tail is dense.
//     The int8 decode form (repro_flash_decode_int8) is the same kernel
//     reading the int8 KV cache directly: K and V int8 codes, and beside
//     them one f32 scale a (key, kv head) for each (the paper's §V-C 8-bit
//     layout), with q and the output in bf16 or f32. A lane loads 16 codes
//     (one 16-byte piece; hd 128: 8 lanes a key, 4 keys a warp step) and
//     its key's two scales by cp.async into the same ring, and dequantizes
//     in registers in f32: a row's score over the codes times the key's
//     scale, then V's codes times p * its scale (K's registers are free
//     before V's are taken; bf16 and f32 K/V run the same loop with scales
//     of 1, which fold away). A decode step then reads (hd + 4)
//     / (2 hd) of the bf16 cache's bytes. Each lane holds 16 elements of a
//     key, twice bf16's 8, so at 8 rows q (scaled) is kept in shared
//     memory instead of 128 registers a thread, read back at each key;
//     at 1-4 rows it stays in registers as in the other instances.
// (b) Forward form, bf16: tensor cores (mma.sync.m16n8k16, f32
//     accumulators: HMMA in the SASS). Bound: bytes and latency at the
//     serving forward (48 keys), operations at long sequences. Each warp
//     owns 16 query rows; a CTA of NW = 1, 2 or 4 warps shares each K/V
//     tile of 64 keys, brought by cp.async (16 bytes a thread, zero-filled
//     past Sk) into a three-stage ring (a stage = K and V, 64 x (hd + 8)
//     bf16 each, the pad keeping ldmatrix free of bank conflicts: 105,216
//     bytes of dynamic shared memory at hd 128). At hd 256 a warp's 16 x
//     256 f32 output accumulators take 128 registers a thread, so Q stays
//     in shared memory (16 x 264 bf16 a warp, loaded once by cp.async) and
//     comes by ldmatrix for each k-step instead of 64 more registers, and
//     the ring has two stages (135,680 + 33,792 bytes; three would pass the
//     227 KB a CTA may have); hd 96 keeps Q there too (FwdLayout). K
//     fragments come by ldmatrix, V's by ldmatrix.trans; P is rounded to
//     bf16 for PV (within the 2e-2 bf16 tolerance; l sums the f32 p). NW
//     is the largest of 4,
//     2, 1 whose grid reaches 132 CTAs: the serving forward has 96 rows per
//     (batch, kv head) and 32 of those, so NW = 1 gives 192 CTAs where
//     64-row tiles give 64. Key tiles that lie wholly above the causal
//     diagonal, outside the window or at negative positions for every row
//     of the CTA are skipped (from the min / max of the CTA's positions);
//     tiles wholly visible to every row skip the mask. A row left with no
//     visible key after a skip is given sum v over all Sk keys and l = Sk,
//     exactly what it would have summed. Warp-level mma, not wgmma:
//     wgmma's 64-row tiles cannot fill the card at 96 rows per kv head
//     without splitting keys, and the serving forward is bound by latency,
//     not by the tensor rate.
// (c) Forward form, f32: CUDA cores (TF32 would break the 2e-5 and f32
//     serve gates). A CTA of 8 warps holds 32 rows (4 per warp) and loads
//     each K/V tile of 32 keys once for all of them (float4 loads, f32
//     shared memory, K padded by a column); lane j scores key j for its
//     warp's 4 rows.
//
// Low-precision modes (`lowp`, the reference's LOWP of
// src/repro/models/layers.py): a run-time argument, uniform across the CTA,
// taken by the bf16 forms (decode and forward). 1: q is scaled and rounded
// to bf16 as the reference does, bf16(q * bf16(scale)), before the dot
// (accumulated in f32), and no scale follows it; the decode form rounds p
// to bf16 for p v (the forward always does). 2: besides, each score is
// rounded to bf16 before the mask (masked keys score bf16(-1e30)) and the
// row max, and p = bf16(exp(bf16(s - bf16(M_c)))) with M_c the reference's
// running max over its key chunks (nc = max(Sk / min(1024, Sk), 1) chunks
// of C = Sk / nc keys, the last taking any remainder; M_c the max over
// chunks 0 .. c, at least -1e30), weighed by exp(M_c - m) in f32; l and the
// output accumulate in f32. Below 2,048 keys that is one chunk, M_c the
// row's max. Both bf16 forms find the chunk maxima by a first pass over K
// in instances of their own (decode: ROWMAX; forward: CHUNKED), which mode
// 2 alone launches; modes 0 and 1 run the other instances, whose
// arithmetic does not know of it. The decode form holds at most kMaxChunks
// chunks a row (the entry point refuses more). The f32 forms and the int8
// decode form take mode 0 only (the entry points refuse any other): on f32
// q the reference computes the mode-0 function under every mode, and the
// int8 cache exists in decode alone, which runs mode 0. Mode 0's arithmetic
// is as it was.
//
// Registers (ptxas, printed by chip_smoke.py's build phase): see PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The library is one object (REPRO_PART 0), or three compiled from this
// source in parallel and linked together (repro_torch/kernels/_build.py):
// REPRO_PART 1 holds the compute-dtype decode form and the entry point
// repro_flash_attention, 2 the int8 decode form, 3 the forward forms.
#ifndef REPRO_PART
#define REPRO_PART 0
#endif
#define REPRO_HAS_PART(k) (REPRO_PART == 0 || REPRO_PART == (k))

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kAbsent = -3.0e38f;   // below kNegInf: a key past the range
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDecodeWarps = 8;
constexpr int kMaxRows = 8;        // decode form: Sq * G rows at most
constexpr int kMaxSplits = 8;      // portable cluster size
constexpr int kRing = 4;           // decode: warp steps in each lane's ring
constexpr int kMaxChunks = 128;    // decode, lowp 2: the reference's key
                                   // chunks of a row (Sk < 129 x 1,024)
constexpr int kTileKeys = 64;      // bf16 forward key tile
constexpr int kMaxFwdWarps = 4;    // bf16 forward: warps of a CTA
constexpr int kMaxListTiles = 1024;  // bf16 forward: tiles with a skip list
constexpr int kF32Warps = 8, kF32RowsPerWarp = 4, kF32Keys = 32;

// exp: the bf16 paths take the fast approximation, f32 the full one
template <typename T>
__device__ __forceinline__ float ex(float x) { return __expf(x); }
template <>
__device__ __forceinline__ float ex<float>(float x) { return expf(x); }

// x rounded to bf16 (nearest even), back in f32: the low-precision modes
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a float as an int of the same order (for an integer atomicMax), and back
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// 16 bytes -> 8 (bf16) or 4 (f32) floats
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<int8_t> {   // the int8 cache's codes, 16 a piece
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
  }
};

// merge (m2, l2, a2) into (m, l, a): the LSE combine. An empty state
// (m = -1e30, l = 0, a = 0) is its identity.
template <typename T, int N>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float m2,
                                      float l2, const float* a2) {
  const float mn = fmaxf(m, m2);
  const float c1 = ex<T>(m - mn), c2 = ex<T>(m2 - mn);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = a[i] * c1 + a2[i] * c2;
  m = mn;
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

// ------------------------------------------------------------ (a) decode
// One key row of HD elements (of the K/V type T: bf16, f32 or the int8
// cache's codes) is PIECES 16-byte pieces. A lane group of LG
// lanes (a power of two, at most a warp) holds one key: lane `sub` holds
// pieces sub + j * LG, j < NP. Where PIECES is not a power of two (hd 96:
// 12 pieces in bf16, 24 in f32) the group is padded to the next one and its
// last LG - ACT lanes hold no piece (they score 0 and add 0; they still
// take part in every shuffle). Where PIECES exceeds a warp (f32 hd 256: 64)
// each lane holds NP = 2 pieces.
template <typename T, int HD>
struct DecodeLayout {
  static constexpr int VEC = Vec<T>::N;             // elements per piece
  static constexpr int PIECES = HD / VEC;
  static constexpr int LG = PIECES > 16 ? 32
                            : PIECES > 8 ? 16
                            : PIECES > 4 ? 8
                            : PIECES > 2 ? 4 : 2;
  static constexpr int NP = (PIECES + LG - 1) / LG;
  static constexpr int ACT = PIECES - (NP - 1) * LG;  // lanes with pieces
  static constexpr int E = NP * VEC;                  // elements per lane
  static_assert(HD % VEC == 0 && (NP == 1 || ACT == LG),
                "decode layout: every lane of a group holds NP pieces");
};

// bytes a lane's ring slot holds: NP pieces of K and of V, the key's
// position, and for the int8 cache its two scales
template <typename KT, int HD>
constexpr int decode_ring_bytes() {
  constexpr bool scaled = std::is_same<KT, int8_t>::value;
  return kDecodeWarps * kRing * 32
         * (2 * 16 * DecodeLayout<KT, HD>::NP + 4 + (scaled ? 8 : 0));
}

// dynamic shared memory of the decode form: the lanes' cp.async ring, and
// after the key loop the warps' partial accumulators (f32 [warps][RM][HD])
// in the same bytes
template <typename KT, int HD, int RM>
constexpr int decode_smem_bytes() {
  constexpr int red = kDecodeWarps * RM * HD * 4;
  return decode_ring_bytes<KT, HD>() > red ? decode_ring_bytes<KT, HD>()
                                           : red;
}

// q, out: (B, Sq, H, HD) of type T; k, v: (B, Sk, KV, HD) of type KT (T,
// or int8 codes with f32 scales k_scale, v_scale (B, Sk, KV)); acc: (B, H,
// Sq, HD), m, l: (B, H, Sq). grid = (B * KV, splits), cluster (1, splits,
// 1), block 32 * kDecodeWarps, dynamic shared memory
// decode_smem_bytes<KT, HD, RM>(). CTA (x, y) takes keys [y * chunk,
// (y + 1) * chunk).
template <typename T, typename KT, int HD, int RM, bool ROWMAX>
__global__ void __launch_bounds__(32 * kDecodeWarps)
flash_decode_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, T* __restrict__ out,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Sq, int Sk, int H, int KV,
                    int causal, int window, float scale, int chunk,
                    int lowp, long long kv_c, long long kv_b,
                    long long s_c, long long s_b) {
  using L = DecodeLayout<KT, HD>;
  constexpr int VEC = L::VEC, LG = L::LG, NP = L::NP, E = L::E;
  constexpr int KPW = 32 / LG;          // keys per warp step
  constexpr int STEP = KPW * kDecodeWarps;
  constexpr int NST = kRing;            // ring stages: warp steps ahead
  constexpr bool SCALED = std::is_same<KT, int8_t>::value;
  constexpr int QV = Vec<T>::N;         // q elements per 16-byte load
  static_assert(VEC % QV == 0, "decode: a piece of K holds whole q loads");
  // q (scaled) in shared memory where registers would not hold it: the
  // int8 cache at 8 rows (16 elements a lane and row)
  constexpr bool Q_SHARED = RM * E > 64;
  __shared__ float red_ml[kDecodeWarps][RM][2];
  __shared__ float fin_acc[RM][HD];
  __shared__ float fin_ml[RM][2];
  // lowp 2 (ROWMAX): each row's key-chunk maxima, as ordered ints for the
  // atomics, then as the running max over the chunks
  __shared__ int chunk_ord[ROWMAX ? RM : 1][ROWMAX ? kMaxChunks : 1];
  __shared__ float chunk_max[ROWMAX ? RM : 1][ROWMAX ? kMaxChunks : 1];
  __shared__ __align__(16) float q_sh[Q_SHARED ? RM : 1][Q_SHARED ? HD : 4];

  const int G = H / KV;
  const int R = Sq * G;
  // grid (lead * KV, splits, B / lead): CTA (x, y, z) serves row b = z *
  // lead + x / KV of the flattened lead, kv head x % KV
  const int bi = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int b = blockIdx.z * (gridDim.x / KV) + bi;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LG, sub = lane % LG;
  const bool holds = sub < L::ACT;      // this lane holds pieces of the key
  const int k_begin = blockIdx.y * chunk;
  const int k_end = min(Sk, k_begin + chunk);
  // lowp: q as the reference scales it, bf16(q * bf16(scale)); lowp 2:
  // masked scores at bf16(-1e30)
  const float qscale = lowp ? bf16r(scale) : scale;
  const float masked = lowp >= 2 ? bf16r(kNegInf) : kNegInf;

  // this lane's hd slice of every row's q (scaled), and each row's position
  float qf[Q_SHARED ? 1 : RM][E];
  int qp[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    qp[r] = 0;
    float qr_f[E];
#pragma unroll
    for (int i = 0; i < E; ++i) qr_f[i] = 0.f;
    if (r < R) {
      const int qi = r / G, h = kvh * G + r % G;
      if (holds) {
        const T* qr = q + ((size_t)(b * Sq + qi) * H + h) * HD + sub * VEC;
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int c = 0; c < VEC / QV; ++c)
            Vec<T>::unpack(
                *reinterpret_cast<const uint4*>(qr + j * LG * VEC + c * QV),
                qr_f + j * VEC + c * QV);
#pragma unroll
        for (int i = 0; i < E; ++i)
          qr_f[i] = lowp ? bf16r(qr_f[i] * qscale) : qr_f[i] * qscale;
      }
      qp[r] = q_pos[(size_t)b * Sq + qi];
    }
    if constexpr (Q_SHARED) {
      // warp 0's first lane group writes it; every warp reads it after
      // the barrier below
      if (holds && warp == 0 && grp == 0) {
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            q_sh[r][(sub + j * LG) * VEC + i] = qr_f[j * VEC + i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) qf[Q_SHARED ? 0 : r][i] = qr_f[i];
    }
  }
  if constexpr (Q_SHARED) __syncthreads();
  // element i of this lane's slice of row r's scaled q
  const auto qval = [&](int r, int i) -> float {
    if constexpr (Q_SHARED)
      return q_sh[r][(sub + (i / VEC) * LG) * VEC + i % VEC];
    else
      return qf[Q_SHARED ? 0 : r][i];
  };
  float m[RM], l[RM], acc[RM][E];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[r][i] = 0.f;
  }

  // the strided lead: row b = c * lead + i of K / V (c = blockIdx.z, i =
  // bi) starts at c * kv_c + i * kv_b elements (its scales at c * s_c + i *
  // s_b), and its (Sk, KV, HD) tail is dense. A contiguous (B, Sk, KV, HD)
  // cache is lead B, kv_b = Sk * KV * HD; one unit's view of a cube cache,
  // (*cube, B, Sk, KV, HD) behind the units axis, is lead B, kv_b = Sk * KV
  // * HD and kv_c the stride of the flattened cube axes: no copy of the
  // slice is made.
  const size_t kv_off = (size_t)blockIdx.z * kv_c + (size_t)bi * kv_b;
  const size_t kv_row = (size_t)KV * HD;
  const KT* kb = k + kv_off + (size_t)kvh * HD + sub * VEC;
  const KT* vb = v + kv_off + (size_t)kvh * HD + sub * VEC;
  const int* kpb = k_pos + (size_t)b * Sk;
  // the int8 cache's scales of this (batch, kv head): key s at s * KV
  const size_t s_off = (size_t)blockIdx.z * s_c + (size_t)bi * s_b;
  const float* ksb = SCALED ? k_scale + s_off + kvh : nullptr;
  const float* vsb = SCALED ? v_scale + s_off + kvh : nullptr;
  // this lane's ring: NST warp steps of its NP 16-byte pieces of K and of V
  // and its key's position, brought by cp.async. A lane reads back only
  // what it copied itself, so its own wait_group orders it: no barrier.
  extern __shared__ __align__(16) unsigned char dsm[];
  uint4* ring_k = reinterpret_cast<uint4*>(dsm) + warp * NST * 32 * NP + lane;
  uint4* ring_v = ring_k + kDecodeWarps * NST * 32 * NP;
  int* ring_p = reinterpret_cast<int*>(reinterpret_cast<uint4*>(dsm)
                                       + 2 * kDecodeWarps * NST * 32 * NP)
                + warp * NST * 32 + lane;
  // the int8 cache's two scales of the key, after every position
  float* ring_ks = reinterpret_cast<float*>(ring_p - warp * NST * 32 - lane)
                   + kDecodeWarps * NST * 32 + warp * NST * 32 + lane;
  float* ring_vs = ring_ks + kDecodeWarps * NST * 32;
  const int first = k_begin + warp * KPW;     // the warp's first step
  const int steps = first < k_end ? (k_end - first + STEP - 1) / STEP : 0;
  // step n into slot n % NST; with_v false: K and the position only
  const auto fetch = [&](int n, bool with_v) {
    const int s = first + grp + n * STEP, slot = n % NST;
    if (n < steps && s < k_end) {   // else the slot is never read
      const size_t off = (size_t)s * kv_row;
      if (holds) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          cp_async16(ring_k + (slot * NP + j) * 32, kb + off + j * LG * VEC,
                     true);
          if (with_v)
            cp_async16(ring_v + (slot * NP + j) * 32,
                       vb + off + j * LG * VEC, true);
        }
      }
      cp_async4(ring_p + slot * 32, kpb + s, true);
      if constexpr (SCALED) {
        cp_async4(ring_ks + slot * 32, ksb + (size_t)s * KV, true);
        cp_async4(ring_vs + slot * 32, vsb + (size_t)s * KV, true);
      }
    }
    cp_async_commit();
  };
  // each row's score over the key in `slot` (the int8 cache: over its
  // codes, times the key's scale; the scale is 1 for bf16 and f32 K/V, and
  // the product by it folds away)
  const auto scores = [&](int slot, float* sc) {
    const int kp = ring_p[slot * 32];
    float kf[E];
#pragma unroll
    for (int i = 0; i < E; ++i) kf[i] = 0.f;
    if (holds) {
#pragma unroll
      for (int j = 0; j < NP; ++j)
        Vec<KT>::unpack(ring_k[(slot * NP + j) * 32], kf + j * VEC);
    }
    float ks = 1.f;
    if constexpr (SCALED) ks = ring_ks[slot * 32];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) d = fmaf(qval(r, i), kf[i], d);
#pragma unroll
      for (int o = LG / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(kFull, d, o);
      float x = d * ks;
      if (lowp >= 2) x = bf16r(x);
      sc[r] = visible(qp[r], kp, causal, window) ? x : masked;
    }
  };

  // lowp 2 (ROWMAX, the instances mode 2 launches): p is rounded as the
  // reference rounds it, against the running max over its key chunks: nc =
  // max(Sk / min(1024, Sk), 1) chunks of C = Sk / nc keys (the last takes
  // any remainder), a key of chunk c rounded as bf16(exp(bf16(s -
  // bf16(M_c)))) with M_c the f32 max of chunks 0 .. c (at least -1e30), and
  // weighed by exp(M_c - m) in f32, m the row's max (M_{nc-1}). A first pass
  // over K alone finds each chunk's max: each lane group keeps the max of
  // its keys in the chunk they are in and folds it into the CTA's (an
  // atomic max on ordered ints in shared memory) as its keys leave the
  // chunk; the cluster's CTAs combine theirs through distributed shared
  // memory, and the running max over the chunks follows. The key loop
  // below then starts from m, so its running max never moves, every
  // rescale factor is exp(0) = 1 and every merge adds. Below 2,048 keys
  // there is one chunk: p against the row's max. It reads K twice: the
  // mode's price in this form. The other modes' instances hold no trace of
  // this pass.
  const int nc = ROWMAX ? max(Sk / min(1024, Sk), 1) : 1;
  const int C = ROWMAX ? Sk / nc : Sk;
  // the chunk of this lane group's key of step 0, tracked as the keys move
  const int c_first = ROWMAX ? min((first + grp) / C, nc - 1) : 0;
  if constexpr (ROWMAX) {
    for (int e = threadIdx.x; e < RM * nc; e += blockDim.x)
      chunk_ord[e / nc][e % nc] = ordered(kAbsent);
    __syncthreads();
    float rmax[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) rmax[r] = kAbsent;
    int c = c_first;
    const auto fold = [&]() {   // the group's maxima into chunk c's
      if (sub == 0) {
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r >= R) break;
          if (rmax[r] != kAbsent)
            atomicMax(&chunk_ord[r][c], ordered(rmax[r]));
          rmax[r] = kAbsent;
        }
      }
    };
#pragma unroll
    for (int n = 0; n < NST - 1; ++n) fetch(n, false);
    for (int n = 0; n < steps; ++n) {         // warp-uniform
      cp_async_wait<NST - 2>();
      const int slot = n % NST;
      float sc[RM];
      scores(slot, sc);
      const int s = first + grp + n * STEP;
      if (s < k_end) {
        while (c < nc - 1 && s >= (c + 1) * C) {
          fold();
          ++c;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          if (r >= R) break;
          rmax[r] = fmaxf(rmax[r], sc[r]);
        }
      }
      fetch(n + NST - 1, false);
    }
    fold();
    cp_async_wait<0>();   // the ring is free for the key loop
    __syncthreads();      // every group's maxima are in chunk_ord
    // each (row, chunk)'s max over the cluster's CTAs, then the running
    // max over the chunks (chunk_ord is not written again)
    if (gridDim.y > 1) cg::this_cluster().sync();
    for (int e = threadIdx.x; e < R * nc; e += blockDim.x) {
      const int r = e / nc, c2 = e % nc;
      int x = chunk_ord[r][c2];
      if (gridDim.y > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        for (int y = 0; y < (int)gridDim.y; ++y)
          x = max(x, *cluster.map_shared_rank(&chunk_ord[r][c2], y));
      }
      chunk_max[r][c2] = unordered(x);
    }
    __syncthreads();
    if (threadIdx.x < R) {
      float run = kNegInf;
      for (int c2 = 0; c2 < nc; ++c2) {
        run = fmaxf(run, chunk_max[threadIdx.x][c2]);
        chunk_max[threadIdx.x][c2] = run;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      m[r] = chunk_max[r][nc - 1];
    }
  }

  [[maybe_unused]] int c_key = c_first;   // ROWMAX: the group's key's chunk
#pragma unroll
  for (int n = 0; n < NST - 1; ++n) fetch(n, true);
  for (int n = 0; n < steps; ++n) {           // warp-uniform
    cp_async_wait<NST - 2>();                 // step n has landed
    const int slot = n % NST;
    const bool exists = first + grp + n * STEP < k_end;
    // each row's score over K, then V (the int8 cache: its codes times p *
    // its scale); K's registers are free before V's are taken
    float sc[RM];
    scores(slot, sc);
    if constexpr (ROWMAX) {   // the chunk of this group's key
      const int s = first + grp + n * STEP;
      while (exists && c_key < nc - 1 && s >= (c_key + 1) * C) ++c_key;
    }
    if (exists) {
      float vf[E];
#pragma unroll
      for (int i = 0; i < E; ++i) vf[i] = 0.f;
      if (holds) {
#pragma unroll
        for (int j = 0; j < NP; ++j)
          Vec<KT>::unpack(ring_v[(slot * NP + j) * 32], vf + j * VEC);
      }
      float vs = 1.f;
      if constexpr (SCALED) vs = ring_vs[slot * 32];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (r >= R) break;
        const float mn = fmaxf(m[r], sc[r]);
        const float c = ex<T>(m[r] - mn);
        float p;
        if constexpr (ROWMAX) {   // mn is the row's max: see the first pass
          const float mc = chunk_max[r][c_key];
          p = bf16r(ex<T>(bf16r(sc[r] - bf16r(mc))));
          if (mc != mn) p *= ex<T>(mc - mn);
        } else {
          p = lowp >= 2 ? bf16r(ex<T>(bf16r(sc[r] - bf16r(mn))))
                        : ex<T>(sc[r] - mn);
        }
        l[r] = l[r] * c + p;
        const float pv = (lowp == 1 ? bf16r(p) : p) * vs;
#pragma unroll
        for (int i = 0; i < E; ++i)
          acc[r][i] = fmaf(pv, vf[i], acc[r][i] * c);
        m[r] = mn;
      }
    }
    fetch(n + NST - 1, true);   // into the slot of step n - 1, consumed
  }

  // lane groups of the warp -> the warp's state, in lanes 0 .. LG-1
#pragma unroll
  for (int o = LG; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      float a2[E];
#pragma unroll
      for (int i = 0; i < E; ++i) a2[i] = __shfl_xor_sync(kFull, acc[r][i], o);
      const float m2 = __shfl_xor_sync(kFull, m[r], o);
      const float l2 = __shfl_xor_sync(kFull, l[r], o);
      merge<T, E>(m[r], l[r], acc[r], m2, l2, a2);
    }
  }
  // the warps' states meet in the ring's bytes: every warp's ring is read
  // (and no copy is in flight) before any is overwritten
  cp_async_wait<0>();
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(dsm);   // [warps][RM][HD]
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      if (holds) {
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            red_acc[(warp * RM + r) * HD + (sub + j * LG) * VEC + i] =
                acc[r][j * VEC + i];
      }
      if (sub == 0) {
        red_ml[warp][r][0] = m[r];
        red_ml[warp][r][1] = l[r];
      }
    }
  }
  __syncthreads();

  const auto emit = [&](int r, int d, float aa, float mm, float ll) {
    const int qi = r / G, h = kvh * G + r % G;
    if (out != nullptr)
      store(out + ((size_t)(b * Sq + qi) * H + h) * HD + d,
            aa / fmaxf(ll, 1e-30f));
    const size_t row = (size_t)(b * H + h) * Sq + qi;
    if (acc_out != nullptr) acc_out[row * HD + d] = aa;
    if (m_out != nullptr && d == 0) {
      m_out[row] = mm;
      l_out[row] = ll;
    }
  };

  // warps -> the CTA's state: written out, or kept in fin_* for the cluster
  const int splits = gridDim.y;
  for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mm = fmaxf(mm, red_ml[w][r][0]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = ex<T>(red_ml[w][r][0] - mm);
      ll += red_ml[w][r][1] * c;
      aa += red_acc[(w * RM + r) * HD + d] * c;
    }
    if (splits == 1) {
      emit(r, d, aa, mm, ll);
    } else {
      fin_acc[r][d] = aa;
      if (d == 0) {
        fin_ml[r][0] = mm;
        fin_ml[r][1] = ll;
      }
    }
  }
  if (splits == 1) return;

  // the cluster's CTAs -> rank 0, from distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
      const int r = e / HD, d = e % HD;
      float mm = kNegInf;
      for (int c = 0; c < splits; ++c)
        mm = fmaxf(mm, *cluster.map_shared_rank(&fin_ml[r][0], c));
      float ll = 0.f, aa = 0.f;
      for (int c = 0; c < splits; ++c) {
        const float w = ex<T>(*cluster.map_shared_rank(&fin_ml[r][0], c) - mm);
        ll += *cluster.map_shared_rank(&fin_ml[r][1], c) * w;
        aa += *cluster.map_shared_rank(&fin_acc[r][d], c) * w;
      }
      emit(r, d, aa, mm, ll);
    }
  }
  cluster.sync();   // every CTA's shared memory stays alive until read
}

// ------------------------------------------------------- (b) bf16 forward
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

// Per head dim: K/V tiles in the ring (three, two at hd 256 where three do
// not fit beside Q), and whether Q lives in shared memory, read by ldmatrix
// per k-step instead of held as KT x 4 registers: at hd 256 a warp's 16 x
// 256 f32 output accumulators alone take 128 registers a thread, and at hd
// 96 ptxas spills the register form (168 registers and 32 bytes of spill
// stores) where the shared form needs no spill.
template <int HD>
struct FwdLayout {
  static constexpr bool Q_SHARED = HD == 96 || HD > 128;
  static constexpr int STAGES = HD > 128 ? 2 : 3;
  static constexpr int LD = HD + 8;   // shared row pitch, elements
};

template <int HD>
constexpr int mma_smem_bytes() {
  using F = FwdLayout<HD>;
  return F::STAGES * (2 * kTileKeys * F::LD * 2 + kTileKeys * 4)
         + (F::Q_SHARED ? kMaxFwdWarps * 16 * F::LD * 2 : 0);
}

// grid = (B * KV, ceil(Sq * G / (16 * NW))), block = 32 * NW (NW = 1, 2, 4),
// dynamic shared memory mma_smem_bytes<HD>(). CHUNKED: the instances mode 2
// launches (see the key loop), over nc chunks of C keys (the launcher's
// count). At least one CTA an SM: with the 128-thread bound alone ptxas
// spilled in chunked instances and held the others to fewer registers
// (hd 128: 173 against 218); the arithmetic, and so every bit, is the same.
// Its time at each head dim against another tree: tools/flash_mode_ab.py.
template <int HD, bool CHUNKED>
__global__ void __launch_bounds__(128, 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int Sq, int Sk, int H,
                     int KV, int causal, int window, float scale, int lowp,
                     int nc, int C) {
  using bf16 = __nv_bfloat16;
  using F = FwdLayout<HD>;
  constexpr int LD = F::LD;
  constexpr int kStages = F::STAGES;
  constexpr int KT = HD / 16;      // k-steps of q k^T
  constexpr int NB = HD / 8;       // n-blocks of p v
  constexpr int CH = HD / 8;       // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);             // [kStages][64][LD]
  bf16* vs = ks + kStages * kTileKeys * LD;             // [kStages][64][LD]
  int* kps = reinterpret_cast<int*>(vs + kStages * kTileKeys * LD);
  // Q_SHARED: the warps' query rows, [kMaxFwdWarps][16][LD]
  bf16* qsm = reinterpret_cast<bf16*>(kps + kStages * kTileKeys);
  __shared__ int tiles[kMaxListTiles];
  __shared__ int n_live_s, qmin_s, qmax_s;
  __shared__ float colsum[4][HD];

  const int G = H / KV, R = Sq * G;
  const int NW = blockDim.x / 32;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, qlane = lane % 4;
  const int cta_row0 = blockIdx.y * 16 * NW;
  const int n_tiles = (Sk + kTileKeys - 1) / kTileKeys;

  // the CTA's query positions: min and max, for the tile skip
  if (threadIdx.x == 0) {
    qmin_s = 0x7fffffff;
    qmax_s = -0x7fffffff - 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * NW; i += blockDim.x) {
    const int r = cta_row0 + i;
    if (r < R) {
      const int p = q_pos[(size_t)b * Sq + r / G];
      atomicMin(&qmin_s, p);
      atomicMax(&qmax_s, p);
    }
  }
  __syncthreads();
  const int qmin = qmin_s, qmax = qmax_s;

  // live key tiles: some key of the tile may be visible to some row here.
  // The list holds 2 t + full: full when every key of tile t exists and is
  // visible to every row here (no mask to apply).
  const bool listed = n_tiles <= kMaxListTiles;
  if (listed) {
    for (int t = warp; t < n_tiles; t += NW) {
      int kmin = 0x7fffffff, kmax = -1, lo = 0x7fffffff, gone = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = t * kTileKeys + h * 32 + lane;
        if (s < Sk) {
          const int p = k_pos[(size_t)b * Sk + s];
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
      const bool live =
          kmax >= 0 && !(causal && kmin > qmax) &&
          !(window > 0 && (long long)qmin - kmax >= window);
      const bool full =
          !gone && lo >= 0 && (!causal || kmax <= qmin) &&
          (window <= 0 || (long long)qmax - kmin < window);
      if (lane == 0) tiles[t] = live ? 1 + full : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int t = 0; t < n_tiles; ++t)
        if (tiles[t]) tiles[n++] = 2 * t + (tiles[t] - 1);
      n_live_s = n;
    }
    __syncthreads();
  }
  const int n_live = listed ? n_live_s : n_tiles;

  const size_t kv_row = (size_t)KV * HD;
  const bf16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  const int* kpb = k_pos + (size_t)b * Sk;
  // with_v false: K and the positions only (the chunk-max pass)
  const auto load_tile = [&](int t, int st, bool with_v = true) {
    bf16* kd = ks + st * kTileKeys * LD;
    bf16* vd = vs + st * kTileKeys * LD;
    for (int e = threadIdx.x; e < kTileKeys * CH; e += blockDim.x) {
      const int j = e / CH, c = e % CH, s = t * kTileKeys + j;
      const bool ok = s < Sk;
      const size_t off = (size_t)(ok ? s : 0) * kv_row + c * 8;
      cp_async16(kd + j * LD + c * 8, kb + off, ok);
      if (with_v) cp_async16(vd + j * LD + c * 8, vb + off, ok);
    }
    for (int j = threadIdx.x; j < kTileKeys; j += blockDim.x) {
      const int s = t * kTileKeys + j;
      cp_async4(kps + st * kTileKeys + j, kpb + (s < Sk ? s : 0), s < Sk);
    }
  };
  const auto qrow = [&](int r) -> size_t {
    return ((size_t)(b * Sq + r / G) * H + kvh * G + r % G) * HD;
  };
  if constexpr (F::Q_SHARED) {   // the warp's 16 rows, in tile 0's group
    bf16* qw = qsm + warp * 16 * LD;
    for (int e = lane; e < 16 * CH; e += 32) {
      const int i = e / CH, c = e % CH, r = cta_row0 + warp * 16 + i;
      cp_async16(qw + i * LD + c * 8, q + (r < R ? qrow(r) + c * 8 : 0),
                 r < R);
    }
  }
  // a pass runs list entries lo .. hi - 1 through a ring of kStages tiles:
  // entry i in stage (i - lo) % kStages, one commit group per entry (empty
  // past the last), kStages - 1 of them ahead (with_v false: K alone), and
  // drain() empties the ring at the pass's end. Modes 0 and 1 run one pass
  // over every live tile, its ring filled here with Q's copies in entry 0's
  // group; the chunked instances run two a chunk (see the key loop), and
  // Q's copies go in a group of their own.
  const auto tile_of = [&](int i) { return listed ? tiles[i] / 2 : i; };
  const auto preload = [&](int lo, int hi, bool with_v) {
#pragma unroll
    for (int n = 0; n < kStages - 1; ++n) {
      if (lo + n < hi) load_tile(tile_of(lo + n), n, with_v);
      cp_async_commit();
    }
  };
  const auto advance = [&](int i, int lo, int hi, bool with_v) {
    cp_async_wait<kStages - 2>();   // entry i has landed
    __syncthreads();   // ... for every thread; entry i - 1 is consumed
    const int nx = i + kStages - 1;
    if (nx < hi) load_tile(tile_of(nx), (nx - lo) % kStages, with_v);
    cp_async_commit();
    return (i - lo) % kStages;
  };
  const auto drain = [&]() {
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the next pass
  };
  if constexpr (CHUNKED)
    cp_async_commit();
  else
    preload(0, n_live, true);

  // this warp's 16 rows: q fragments (unless Q_SHARED), positions
  const int r0 = cta_row0 + warp * 16 + quad, r1 = r0 + 8;
  const bool ok0 = r0 < R, ok1 = r1 < R;
  const size_t qo0 = ok0 ? qrow(r0) : 0, qo1 = ok1 ? qrow(r1) : 0;
  uint32_t qa[F::Q_SHARED ? 1 : KT][4];
  if constexpr (!F::Q_SHARED) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int c = kk * 16 + 2 * qlane;
      qa[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(q + qo0 + c) : 0u;
      qa[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(q + qo1 + c) : 0u;
      qa[kk][2] =
          ok0 ? *reinterpret_cast<const uint32_t*>(q + qo0 + c + 8) : 0u;
      qa[kk][3] =
          ok1 ? *reinterpret_cast<const uint32_t*>(q + qo1 + c + 8) : 0u;
    }
  }
  // lowp: q as the reference scales it, bf16(q * bf16(scale)), in the
  // fragments (or in the warp's rows of shared memory), and the scores
  // take no scale after the dot
  const float qscale = bf16r(scale);
  if (lowp) {
    if constexpr (F::Q_SHARED) {
      if constexpr (CHUNKED)
        cp_async_wait<0>();             // Q's own group
      else
        cp_async_wait<kStages - 2>();   // Q came with tile 0's group
      __syncwarp();
      bf16* qw = qsm + warp * 16 * LD;
      for (int e = lane; e < 16 * HD / 2; e += 32) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(
            qw + (e / (HD / 2)) * LD + 2 * (e % (HD / 2)));
        const float2 f = __bfloat1622float2(*h);
        *h = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(
              &qa[kk][c]);
          const float2 f = __bfloat1622float2(h);
          qa[kk][c] = pack_bf16(f.x * qscale, f.y * qscale);
        }
    }
  }
  const float masked = CHUNKED ? bf16r(kNegInf) : kNegInf;
  const int qp0 = ok0 ? q_pos[(size_t)b * Sq + r0 / G] : 0;
  const int qp1 = ok1 ? q_pos[(size_t)b * Sq + r1 / G] : 0;

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;

  // the warp's 16 rows against the 64 keys of the tile at kt: q k^T in f32
  // accumulators (no scale applied)
  const auto score = [&](const bf16* kt, float (&s)[8][4]) {
    if constexpr (F::Q_SHARED) {
      // two k-steps at a time: their Q fragments by ldmatrix.x4 (rows
      // lane % 16, columns + 8 for lanes 16-31), then every key block
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* qr =
          qsm + (warp * 16 + (lane & 15)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int kk = 0; kk < KT; kk += 2) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, qr + 16 * kk);
        ldmatrix_x4(a1, qr + 16 * kk + 16);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (8 * j + (lane & 7)) * LD + 8 * (lane >> 3)
                              + 16 * kk);
          mma16816(s[j], a0, bk[0], bk[1]);
          mma16816(s[j], a1, bk[2], bk[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        // K fragments of keys 8j.., two k-steps per ldmatrix.x4
        const bf16* kr = kt + (8 * j + (lane & 7)) * LD + 8 * (lane >> 3);
#pragma unroll
        for (int kk = 0; kk < KT; kk += 2) {
          uint32_t bk[4];
          if (KT == 1) {   // hd 16: the other two matrices are not read
            bk[0] = *reinterpret_cast<const uint32_t*>(
                kt + (8 * j + quad) * LD + 2 * qlane);
            bk[1] = *reinterpret_cast<const uint32_t*>(
                kt + (8 * j + quad) * LD + 2 * qlane + 8);
          } else {
            ldmatrix_x4(bk, kr + 16 * kk);
          }
          mma16816(s[j], qa[kk], bk[0], bk[1]);
          if (kk + 1 < KT) mma16816(s[j], qa[kk + 1], bk[2], bk[3]);
        }
      }
    }
  };
  // the scores of tile t, scaled (mode 0; the other modes scaled q) and in
  // mode 2 rounded to bf16, then masked: masked pairs score `masked`, keys
  // outside [k_lo, k_hi) kAbsent; full: no mask to apply. mx0 / mx1: each
  // row's max over the keys in range (masked ones score -1e30)
  const auto mask = [&](float (&s)[8][4], int t, bool full, const int* kpt,
                        int k_lo, int k_hi, float& mx0, float& mx1) {
    mx0 = kAbsent;
    mx1 = kAbsent;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = CHUNKED || lowp ? s[j][e] : s[j][e] * scale;
        if (CHUNKED) x = bf16r(x);
        if (!full) {   // CTA-uniform
          const int jj = 8 * j + 2 * qlane + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          const int kk = t * kTileKeys + jj;
          x = visible(qp, kpt[jj], causal, window) ? x : masked;
          x = kk >= k_lo && kk < k_hi ? x : kAbsent;
        }
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
  };
  // p in place of each score, against its row's r0 / r1: exp(s - r), in
  // mode 2 bf16(exp(bf16(s - r))) with r in bf16 (absent keys: 0); ps0 /
  // ps1 each row's sum of this thread's p
  const auto probs = [&](float (&s)[8][4], float r0, float r1, float& ps0,
                         float& ps1) {
    ps0 = ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        float p = 0.f;
        if (x != kAbsent) {
          p = CHUNKED ? bf16r(__expf(bf16r(x - (e < 2 ? r0 : r1))))
                      : __expf(x - (e < 2 ? r0 : r1));
        }
        s[j][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
  };
  const auto rescale = [&](float c0, float c1) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      o[nb][0] *= c0;
      o[nb][1] *= c0;
      o[nb][2] *= c1;
      o[nb][3] *= c1;
    }
  };
  // o += p v: p from the score accumulators (rounded to bf16), v of the
  // tile at vt by ldmatrix.trans, two n-blocks per load
  const auto add_pv = [&](const bf16* vt, const float (&s)[8][4]) {
#pragma unroll
    for (int kt2 = 0; kt2 < kTileKeys / 16; ++kt2) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kt2][0], s[2 * kt2][1]);
      a[1] = pack_bf16(s[2 * kt2][2], s[2 * kt2][3]);
      a[2] = pack_bf16(s[2 * kt2 + 1][0], s[2 * kt2 + 1][1]);
      a[3] = pack_bf16(s[2 * kt2 + 1][2], s[2 * kt2 + 1][3]);
      const bf16* vr =
          vt + (16 * kt2 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
          8 * (lane >> 4);
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vr + 16 * nb2);
        mma16816(o[2 * nb2], a, bv[0], bv[1]);
        mma16816(o[2 * nb2 + 1], a, bv[2], bv[3]);
      }
    }
  };

  if constexpr (!CHUNKED) {
    // modes 0 and 1: one pass; a tile's p against the running max of the
    // tiles so far, (l, o) rescaled by exp(m_old - m_new) in f32 a tile
    for (int i = 0; i < n_live; ++i) {
      const int st = advance(i, 0, n_live, true);
      float s[8][4], mx0, mx1, ps0, ps1;
      score(ks + st * kTileKeys * LD, s);
      mask(s, tile_of(i), listed && (tiles[i] & 1), kps + st * kTileKeys, 0,
           Sk, mx0, mx1);
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      probs(s, mn0, mn1, ps0, ps1);
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
      rescale(c0, c1);
      add_pv(vs + st * kTileKeys * LD, s);
    }
  } else {
    // Mode 2 (the reference's LOWP 2) rounds p against the running max
    // over the reference's key chunks: nc = max(Sk / min(1024, Sk), 1)
    // chunks of C = Sk / nc keys (the last takes any remainder), and a key
    // of chunk c has p = bf16(exp(bf16(s - bf16(M_c)))), M_c the f32 max
    // of the rounded scores of chunks 0 .. c (at least -1e30). Each chunk
    // runs two passes over its live tiles: the first reads K alone and
    // raises M to M_c, the second rounds and sums p; (l, o) are rescaled by
    // exp(M_{c-1} - M_c) in f32 once at the chunk's start, as the
    // reference's chunk loop rescales. A tile across a chunk's boundary
    // runs in both chunks, each pass taking its own keys. Below 2,048 keys
    // there is one chunk, p against the row's max. K is read twice: the
    // mode's price in this form.
    float M0 = kNegInf, M1 = kNegInf;
    int lo = 0;   // the first list entry that meets chunk c
    for (int c = 0; c < nc; ++c) {
      const int k_lo = c * C, k_hi = c == nc - 1 ? Sk : k_lo + C;
      while (lo < n_live && (tile_of(lo) + 1) * kTileKeys <= k_lo) ++lo;
      int hi = lo;
      while (hi < n_live && tile_of(hi) * kTileKeys < k_hi) ++hi;
      // no mask: a tile visible to every row, wholly inside the chunk
      const auto full = [&](int i) {
        const int t = tile_of(i);
        return listed && (tiles[i] & 1) && t * kTileKeys >= k_lo &&
               (t + 1) * kTileKeys <= k_hi;
      };
      preload(lo, hi, false);   // pass 1: M up to M_c
      for (int i = lo; i < hi; ++i) {
        const int st = advance(i, lo, hi, false);
        float s[8][4], mx0, mx1;
        score(ks + st * kTileKeys * LD, s);
        mask(s, tile_of(i), full(i), kps + st * kTileKeys, k_lo, k_hi, mx0,
             mx1);
        M0 = fmaxf(M0, mx0);
        M1 = fmaxf(M1, mx1);
      }
      drain();
      const float c0 = __expf(m0 - M0), c1 = __expf(m1 - M1);
      m0 = M0;
      m1 = M1;
      l0 *= c0;
      l1 *= c1;
      rescale(c0, c1);
      const float mb0 = bf16r(M0), mb1 = bf16r(M1);
      preload(lo, hi, true);    // pass 2: p, l and o
      for (int i = lo; i < hi; ++i) {
        const int st = advance(i, lo, hi, true);
        float s[8][4], mx0, mx1, ps0, ps1;
        score(ks + st * kTileKeys * LD, s);
        mask(s, tile_of(i), full(i), kps + st * kTileKeys, k_lo, k_hi, mx0,
             mx1);
        probs(s, mb0, mb1, ps0, ps1);
        l0 += ps0;
        l1 += ps1;
        add_pv(vs + st * kTileKeys * LD, s);
      }
      drain();
    }
  }
  cp_async_wait<0>();   // Q_SHARED with every tile skipped: Q's copies

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  // a row with no visible key in the tiles it ran (m still -1e30) whose CTA
  // skipped tiles: sum v over all Sk keys, l = Sk, as if it had run them all
  const bool dead0 = ok0 && m0 == kNegInf, dead1 = ok1 && m1 == kNegInf;
  if (n_live < n_tiles && __any_sync(kFull, dead0 || dead1)) {
    for (int d = lane; d < HD; d += 32) {
      float sum = 0.f;
      for (int s2 = 0; s2 < Sk; ++s2)
        sum += __bfloat162float(vb[(size_t)s2 * kv_row + d]);
      colsum[warp][d] = sum;
    }
    __syncwarp();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = 8 * nb + 2 * qlane;
      if (dead0) {
        o[nb][0] = colsum[warp][c];
        o[nb][1] = colsum[warp][c + 1];
      }
      if (dead1) {
        o[nb][2] = colsum[warp][c];
        o[nb][3] = colsum[warp][c + 1];
      }
    }
    if (dead0) l0 = (float)Sk;
    if (dead1) l1 = (float)Sk;
  }

  if (out != nullptr) {
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = 8 * nb + 2 * qlane;
      if (ok0)
        *reinterpret_cast<__nv_bfloat162*>(out + qo0 + c) =
            __floats2bfloat162_rn(o[nb][0] * i0, o[nb][1] * i0);
      if (ok1)
        *reinterpret_cast<__nv_bfloat162*>(out + qo1 + c) =
            __floats2bfloat162_rn(o[nb][2] * i1, o[nb][3] * i1);
    }
  }
  if (acc_out != nullptr || m_out != nullptr) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = h2 ? r1 : r0;
      if (!(h2 ? ok1 : ok0)) continue;
      const size_t row = (size_t)(b * H + kvh * G + r % G) * Sq + r / G;
      if (acc_out != nullptr) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          *reinterpret_cast<float2*>(acc_out + row * HD + 8 * nb
                                     + 2 * qlane) =
              make_float2(o[nb][2 * h2], o[nb][2 * h2 + 1]);
      }
      if (m_out != nullptr && qlane == 0) {
        m_out[row] = h2 ? m1 : m0;
        l_out[row] = h2 ? l1 : l0;
      }
    }
  }
}

// -------------------------------------------------------- (c) f32 forward
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int HD>
constexpr int f32_smem_bytes() {
  return (kF32Keys * (HD + 1) + kF32Keys * HD
          + kF32Warps * kF32RowsPerWarp * HD) * 4 + kF32Keys * 4;
}

// grid = (B * KV, ceil(Sq * G / 32)), block = 32 * kF32Warps, dynamic
// shared memory f32_smem_bytes<HD>(). Warp w owns rows 4w .. 4w + 3 of the
// CTA's 32.
template <int HD>
__global__ void __launch_bounds__(32 * kF32Warps)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, float* __restrict__ out,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int Sq, int Sk, int H,
                     int KV, int causal, int window, float scale) {
  constexpr int KPER = (HD + 31) / 32;   // head-dim entries per lane
  constexpr int RW = kF32RowsPerWarp;
  constexpr int C4 = HD / 4;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                                   // [32][HD + 1]
  float* vs = ks + kF32Keys * (HD + 1);              // [32][HD]
  float* qs = vs + kF32Keys * HD;                    // [32 rows][HD]
  int* kp = reinterpret_cast<int*>(qs + kF32Warps * RW * HD);  // [32]

  const int G = H / KV, R = Sq * G;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kF32Warps * RW;
  const auto qrow = [&](int r) -> size_t {
    return ((size_t)(b * Sq + r / G) * H + kvh * G + r % G) * HD;
  };
  for (int e = threadIdx.x; e < kF32Warps * RW * HD; e += blockDim.x) {
    const int rr = e / HD, d = e % HD, r = row0 + rr;
    qs[e] = r < R ? q[qrow(r) + d] * scale : 0.f;
  }
  int qp[RW];
  float m[RW], l[RW], acc[RW][KPER];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = row0 + warp * RW + i;
    qp[i] = r < R ? q_pos[(size_t)b * Sq + r / G] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < KPER; ++c) acc[i][c] = 0.f;
  }

  const size_t kv_row = (size_t)KV * HD;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  for (int k0 = 0; k0 < Sk; k0 += kF32Keys) {
    __syncthreads();   // the previous tile is consumed (and qs written)
    for (int e = threadIdx.x; e < kF32Keys * C4; e += blockDim.x) {
      const int j = e / C4, c = e % C4, s = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (s < Sk) {
        kx = *reinterpret_cast<const float4*>(kb + (size_t)s * kv_row + 4 * c);
        vx = *reinterpret_cast<const float4*>(vb + (size_t)s * kv_row + 4 * c);
      }
      float* kd = ks + j * (HD + 1) + 4 * c;
      kd[0] = kx.x;
      kd[1] = kx.y;
      kd[2] = kx.z;
      kd[3] = kx.w;
      *reinterpret_cast<float4*>(vs + j * HD + 4 * c) = vx;
    }
    if (threadIdx.x < kF32Keys) {
      const int s = k0 + threadIdx.x;
      kp[threadIdx.x] = s < Sk ? k_pos[(size_t)b * Sk + s] : 0;
    }
    __syncthreads();

    // lane j scores key k0 + j for the warp's rows
    const bool exists = k0 + lane < Sk;
    float sc[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) sc[i] = 0.f;
    const float* kr = ks + lane * (HD + 1);
    const float* qw = qs + warp * RW * HD;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kx = kr[d];
#pragma unroll
      for (int i = 0; i < RW; ++i) sc[i] = fmaf(qw[i * HD + d], kx, sc[i]);
    }
    float p[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float x = visible(qp[i], kp[lane], causal, window) ? sc[i]
                                                               : kNegInf;
      const float mn = fmaxf(m[i], warp_max(exists ? x : kAbsent));
      p[i] = exists ? expf(x - mn) : 0.f;
      const float c = expf(m[i] - mn);
      l[i] = l[i] * c + warp_sum(p[i]);
#pragma unroll
      for (int cc = 0; cc < KPER; ++cc) acc[i][cc] *= c;
      m[i] = mn;
    }
    const int n = min(kF32Keys, Sk - k0);
    for (int j = 0; j < n; ++j) {
      float pj[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) pj[i] = __shfl_sync(kFull, p[i], j);
#pragma unroll
      for (int cc = 0; cc < KPER; ++cc) {
        const int d = lane + 32 * cc;
        if (d < HD) {
          const float vx = vs[j * HD + d];
#pragma unroll
          for (int i = 0; i < RW; ++i) acc[i][cc] = fmaf(pj[i], vx, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = row0 + warp * RW + i;
    if (r >= R) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const size_t row = (size_t)(b * H + kvh * G + r % G) * Sq + r / G;
#pragma unroll
    for (int cc = 0; cc < KPER; ++cc) {
      const int d = lane + 32 * cc;
      if (d >= HD) continue;
      if (out != nullptr) out[qrow(r) + d] = acc[i][cc] * inv;
      if (acc_out != nullptr) acc_out[row * HD + d] = acc[i][cc];
    }
    if (m_out != nullptr && lane == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
  }
}

// ------------------------------------------------------------- launching
struct Args {
  const void *q, *k, *v;
  const int *qp, *kp;
  void* out;
  float *acc, *m, *l;
  int Sq, Sk, H, KV, causal, window;
  float scale;
  const float* ks = nullptr;   // the int8 cache's scales
  const float* vs = nullptr;
  int lowp = 0;                // the low-precision mode (bf16 forms)
  // the decode form's K / V lead (see flash_decode_kernel): row b at (b /
  // lead) * kv_c + (b % lead) * kv_b elements, its scales at s_c / s_b;
  // the grid's z axis is b / lead
  long long kv_c = 0, kv_b = 0, s_c = 0, s_b = 0;
};

template <typename T, typename KT, int HD, int RM, bool ROWMAX>
cudaError_t launch_decode_kernel(const Args& a, dim3 grid, int chunk,
                                 cudaStream_t stream) {
  constexpr int bytes = decode_smem_bytes<KT, HD, RM>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<T, KT, HD, RM, ROWMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * kDecodeWarps);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = grid.y > 1 ? 1 : 0;
  return cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<T, KT, HD, RM, ROWMAX>,
      static_cast<const T*>(a.q),
      static_cast<const KT*>(a.k), static_cast<const KT*>(a.v), a.ks, a.vs,
      a.qp, a.kp, static_cast<T*>(a.out), a.acc, a.m, a.l, a.Sq, a.Sk, a.H,
      a.KV, a.causal, a.window, a.scale, chunk, a.lowp, a.kv_c, a.kv_b,
      a.s_c, a.s_b);
}

// mode 2 on bf16 K / V takes the ROWMAX instances; every other launch the
// plain ones
template <typename T, typename KT, int HD, int RM>
cudaError_t launch_decode(const Args& a, dim3 grid, int chunk,
                          cudaStream_t stream) {
  if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
    if (a.lowp == 2)
      return launch_decode_kernel<T, KT, HD, RM, true>(a, grid, chunk,
                                                       stream);
  }
  return launch_decode_kernel<T, KT, HD, RM, false>(a, grid, chunk, stream);
}

template <typename T, typename KT, int HD>
cudaError_t decode_rows(const Args& a, int rows, dim3 grid, int chunk,
                        cudaStream_t s) {
  if (rows <= 1) return launch_decode<T, KT, HD, 1>(a, grid, chunk, s);
  if (rows <= 2) return launch_decode<T, KT, HD, 2>(a, grid, chunk, s);
  if (rows <= 4) return launch_decode<T, KT, HD, 4>(a, grid, chunk, s);
  return launch_decode<T, KT, HD, 8>(a, grid, chunk, s);
}

template <int HD, bool CHUNKED>
cudaError_t launch_forward_mma(const Args& a, dim3 grid, int warps,
                               cudaStream_t s) {
  constexpr int bytes = mma_smem_bytes<HD>();
  const int nc = a.Sk < 1024 ? 1 : a.Sk / 1024;   // the reference's chunks
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD, CHUNKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  using bf16 = __nv_bfloat16;
  flash_fwd_mma_kernel<HD, CHUNKED><<<grid, 32 * warps, bytes, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.qp, a.kp, static_cast<bf16*>(a.out),
      a.acc, a.m, a.l, a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.scale,
      a.lowp, nc, a.Sk / nc);
  return cudaGetLastError();
}

// mode 2 takes the CHUNKED instances; modes 0 and 1 the others
template <int HD>
cudaError_t launch_forward_bf16(const Args& a, dim3 grid, int warps,
                                cudaStream_t s) {
  return a.lowp == 2 ? launch_forward_mma<HD, true>(a, grid, warps, s)
                     : launch_forward_mma<HD, false>(a, grid, warps, s);
}

template <int HD>
cudaError_t launch_forward_f32(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr int bytes = f32_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  flash_fwd_f32_kernel<HD><<<grid, 32 * kF32Warps, bytes, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.qp, a.kp, static_cast<float*>(a.out),
      a.acc, a.m, a.l, a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

#define REPRO_FLASH_HD(FN, ...)                       \
  switch (hd) {                                       \
    case 16: return FN<16>(__VA_ARGS__);              \
    case 32: return FN<32>(__VA_ARGS__);              \
    case 64: return FN<64>(__VA_ARGS__);              \
    case 96: return FN<96>(__VA_ARGS__);              \
    case 128: return FN<128>(__VA_ARGS__);            \
    case 256: return FN<256>(__VA_ARGS__);            \
    default: return cudaErrorInvalidValue;            \
  }

template <typename T, typename KT = T>
cudaError_t decode_hd(int hd, const Args& a, int rows, dim3 grid, int chunk,
                      cudaStream_t s) {
  switch (hd) {
    case 16: return decode_rows<T, KT, 16>(a, rows, grid, chunk, s);
    case 32: return decode_rows<T, KT, 32>(a, rows, grid, chunk, s);
    case 64: return decode_rows<T, KT, 64>(a, rows, grid, chunk, s);
    case 96: return decode_rows<T, KT, 96>(a, rows, grid, chunk, s);
    case 128: return decode_rows<T, KT, 128>(a, rows, grid, chunk, s);
    case 256: return decode_rows<T, KT, 256>(a, rows, grid, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

// the decode geometry's checks, shared by both entry points: the rows and
// splits, and a K / V lead that divides B with 16-byte aligned row starts
// (`elem` bytes an element)
bool decode_geometry_ok(int R, int Sk, int row_tile, int splits, int B,
                        int lead, long long kv_c, long long kv_b, int elem) {
  if (row_tile != R || R > kMaxRows || splits < 1 || splits > kMaxSplits ||
      splits > Sk)
    return false;
  if (lead < 1 || B % lead != 0 || B / lead > 65535 || kv_c < 0 ||
      kv_b < 0 || (kv_c * elem) % 16 != 0 || (kv_b * elem) % 16 != 0)
    return false;
  const int chunk = (Sk + splits - 1) / splits;
  return (splits - 1) * chunk < Sk;
}

#if REPRO_HAS_PART(3)
cudaError_t forward_bf16(int hd, const Args& a, dim3 grid, int warps,
                         cudaStream_t s) {
  REPRO_FLASH_HD(launch_forward_bf16, a, grid, warps, s)
}

cudaError_t forward_f32(int hd, const Args& a, dim3 grid, cudaStream_t s) {
  REPRO_FLASH_HD(launch_forward_f32, a, grid, s)
}
#endif
#undef REPRO_FLASH_HD

}  // namespace

extern "C" {

// The forward form of repro_flash_attention (form 1), its arguments
// checked there but for the row tile; defined in part 3.
int repro_flash_forward(int dtype, const void* q, const void* k,
                        const void* v, const void* q_pos, const void* k_pos,
                        void* out, void* acc, void* m, void* l, int B, int Sq,
                        int Sk, int H, int KV, int hd, int causal, int window,
                        float scale, int row_tile, int lowp, void* stream);

#if REPRO_HAS_PART(3)
int repro_flash_forward(int dtype, const void* q, const void* k,
                        const void* v, const void* q_pos, const void* k_pos,
                        void* out, void* acc, void* m, void* l, int B, int Sq,
                        int Sk, int H, int KV, int hd, int causal, int window,
                        float scale, int row_tile, int lowp, void* stream) {
  if (dtype == 1 ? (row_tile != 16 && row_tile != 32 && row_tile != 64)
                 : row_tile != kF32Warps * kF32RowsPerWarp)
    return cudaErrorInvalidValue;
  const int R = Sq * (H / KV);
  const int tiles = (R + row_tile - 1) / row_tile;
  if (tiles > 65535) return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const int*>(q_pos),
               static_cast<const int*>(k_pos), out,
               static_cast<float*>(acc), static_cast<float*>(m),
               static_cast<float*>(l), Sq, Sk, H, KV, causal, window, scale};
  a.lowp = lowp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * KV, tiles);
  return dtype == 1 ? forward_bf16(hd, a, grid, row_tile / 16, s)
                    : forward_f32(hd, a, grid, s);
}
#endif

#if REPRO_HAS_PART(1)
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). `out` (the
// normalized output), `acc` and the pair `m`, `l` (the row statistics) may
// each be null: the partials are all three; the training forward asks for
// `out` with `m` and `l`, which its backward (flash_bwd.cu) reads.
// form 0 = decode (row_tile = Sq * G <= 8, `splits` CTAs per (batch, kv
// head) in one cluster), form 1 = forward (row_tile query rows per CTA: 16,
// 32 or 64 in bf16, 32 in f32; splits = 1) -- flash.launch_geometry.
// `lowp`: the low-precision mode, 0, 1 or 2 in bf16 and 0 in f32.
// `lead`, `kv_c`, `kv_b`: the lead of k and v, in elements (row b at (b /
// lead) * kv_c + (b % lead) * kv_b, its (Sk, KV, hd) tail dense): any
// lead dividing B (B / lead <= 65535, the grid's z) in the decode form, a
// contiguous one (kv_b = Sk * KV * hd, kv_c = lead * kv_b) in the forward
// form.
// Returns the cudaError_t of the launch, or of setting the forward's
// dynamic shared-memory size (0 on success); nothing is synchronized and
// nothing is allocated.
int repro_flash_attention(int dtype, const void* q, const void* k,
                          const void* v, const void* q_pos, const void* k_pos,
                          void* out, void* acc, void* m, void* l, int B,
                          int Sq, int Sk, int H, int KV, int hd, int causal,
                          int window, float scale, int form, int row_tile,
                          int splits, int lowp, int lead, long long kv_c,
                          long long kv_b, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1) || lowp < 0 || lowp > 2 ||
      (dtype == 0 && lowp != 0))
    return cudaErrorInvalidValue;
  // the decode form's mode 2 keeps a row's chunk maxima in shared memory
  if (form == 0 && lowp == 2 && (Sk < 1024 ? 1 : Sk / 1024) > kMaxChunks)
    return cudaErrorInvalidValue;
  const int R = Sq * (H / KV);
  Args a{q, k, v, static_cast<const int*>(q_pos),
               static_cast<const int*>(k_pos), out,
               static_cast<float*>(acc), static_cast<float*>(m),
               static_cast<float*>(l), Sq, Sk, H, KV, causal, window, scale};
  a.lowp = lowp;
  a.kv_c = kv_c;
  a.kv_b = kv_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    if (!decode_geometry_ok(R, Sk, row_tile, splits, B, lead, kv_c, kv_b,
                            dtype == 0 ? 4 : 2))
      return cudaErrorInvalidValue;
    const int chunk = (Sk + splits - 1) / splits;
    const dim3 grid(lead * KV, splits, B / lead);
    return dtype == 0 ? decode_hd<float>(hd, a, R, grid, chunk, s)
                      : decode_hd<__nv_bfloat16>(hd, a, R, grid, chunk, s);
  }
  // the forward forms take contiguous K / V only
  if (form != 1 || splits != 1 || kv_b != (long long)Sk * KV * hd ||
      (B / lead > 1 && kv_c != lead * kv_b))
    return cudaErrorInvalidValue;
  return repro_flash_forward(dtype, q, k, v, q_pos, k_pos, out, acc, m, l, B,
                             Sq, Sk, H, KV, hd, causal, window, scale,
                             row_tile, lowp, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif

#if REPRO_HAS_PART(2)
// The int8 decode form: q (and `out` / the partials) in `dtype` (0 =
// float32, 1 = bfloat16); k, v int8 codes (B, Sk, KV, hd); k_scale,
// v_scale f32 (B, Sk, KV). Key j of kv head h is k[j, h] * k_scale[j, h].
// The decode geometry only (row_tile = Sq * G <= 8, `splits` CTAs a
// (batch, kv head) in one cluster), as form 0 above, with the lead of k /
// v (`lead`, `kv_c`, `kv_b`) and of the scales (`s_c`, `s_b`).
int repro_flash_decode_int8(int dtype, const void* q, const void* k,
                            const void* v, const void* k_scale,
                            const void* v_scale, const void* q_pos,
                            const void* k_pos, void* out, void* acc, void* m,
                            void* l, int B, int Sq, int Sk, int H, int KV,
                            int hd, int causal, int window, float scale,
                            int row_tile, int splits, int lead,
                            long long kv_c, long long kv_b, long long s_c,
                            long long s_b, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1) || k_scale == nullptr || v_scale == nullptr ||
      s_c < 0 || s_b < 0)
    return cudaErrorInvalidValue;
  const int R = Sq * (H / KV);
  if (!decode_geometry_ok(R, Sk, row_tile, splits, B, lead, kv_c, kv_b, 1))
    return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const int*>(q_pos),
         static_cast<const int*>(k_pos), out, static_cast<float*>(acc),
         static_cast<float*>(m), static_cast<float*>(l), Sq, Sk, H, KV,
         causal, window, scale};
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.kv_c = kv_c;
  a.kv_b = kv_b;
  a.s_c = s_c;
  a.s_b = s_b;
  const int chunk = (Sk + splits - 1) / splits;
  const dim3 grid(lead * KV, splits, B / lead);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? decode_hd<float, int8_t>(hd, a, R, grid, chunk, s)
             : decode_hd<__nv_bfloat16, int8_t>(hd, a, R, grid, chunk, s);
}
#endif

}  // extern "C"
