// Landmark-attention kernels for Hopper (sm_90a): the O(S·L) stages of
// sketched attention.
//
// Two kernels replace the TPU's Pallas kernels in
// src/repro/kernels/landmark_attention/kernel.py (LA below):
//
//   landmark_attention (LA:54)  out = softmax(q k̃ᵀ/√Dh + bias) · M
//   landmark_stats     (LA:138) W   = softmax(q̃ k̃ᵀ/√Dh), columns ≥ l_valid masked
//                               BmV = softmax(q̃ Kᵀ/√Dh) · V, keys ≥ n_valid masked
//
// Both are batched over P independent problems (B·Hkv on the decode path,
// B·H in accum_attention).  Inputs are float32 or bfloat16; every sum is
// accumulated in float32 at float32 accuracy, as the TPU kernels' f32
// accumulation.  Masked logits are −1e30, never −inf, so a row whose every
// entry is masked gets uniform weights, as in the reference, and no NaN.
// Keys past the end of the input (the ragged last tile) get weight exactly 0.
//
// The TPU kernel kept k̃ and M whole in VMEM (LA:80–82).  At the decode shape
// (L = 1024, Dh = Dv = 128, float32) they are 512 KB each against a block's
// 227 KB of shared memory, so here every problem walks its keys with an
// online softmax (running max, denominator and accumulator per query row),
// flash-attention style.  Blocks run in parallel and in no order, so where
// one problem's keys are split across blocks (flash-decoding: the decode
// shape has only G = 4 query rows per problem, 32 problems at batch 4, far
// too few blocks for 132 SMs) each block writes its partial (max,
// denominator, accumulator) to a scratch and the pieces are combined in
// split order: by the last block of the problem to arrive on the decode
// sweep, by a second launch on the tensor-core sweep.  No float atomics:
// every sum has one owner and a fixed order, so results are the same bits
// from run to run.
//
// Two sweeps, chosen by the number of query rows S of a problem:
//
//   S ≤ 8 (decode: G rows a problem; landmark_stats' BmV where L ≤ 8),
//     attend_decode_kernel: bound by bytes (k̃ and M read once, 33.6 MB at
//     batch 4, against 67 MFLOP).  One warp reads one key row a step with a
//     16-byte load a lane, serves all of the problem's rows from registers,
//     and keeps several rows in flight; the splits are combined in the same
//     launch (see the kernel's note below).
//
//   S > 8 (the F-stage of accum_attention, landmark_stats' BmV sweep),
//     attend_mma_kernel: bound by operations, 2·S·L·(Dh + Dv) a problem
//     (≈ 550 GFLOP at B·H = 32, S = 32768, L = 1024).  IEEE FMA peaks at
//     67 TFLOP/s; the tensor cores take TF32 at 495.  Each float32 operand x
//     is split into hi = tf32(x) and lo = tf32(x − hi), and each product is
//     formed as lo·hi + hi·lo + hi·hi by mma.sync m16n8k8 into a float32
//     accumulator ("3×TF32"): about float32 accuracy at a third of the
//     TF32 rate.  bfloat16 inputs widen exactly into TF32, so their lo is 0
//     and its terms are skipped.  A warp owns 16 query rows (NW = 4 or 8
//     warps a block: 64 or 128 rows).  The block's Q tile is staged once in
//     shared memory and split at each fragment read; 64-key (32 where a
//     float32 head dim above 192 would overflow shared memory) K and V tiles
//     stream through a two-stage ring filled by 16-byte cp.async, tile t + 1
//     in flight while tile t computes, one barrier a tile.  The scores stay
//     in registers: the mma's accumulator layout is its A-fragment layout
//     once the k index of the P·V product is permuted (k = t ↔ key 2t,
//     k = t + 4 ↔ key 2t + 1), and likewise the head dim of the score
//     product, so every fragment read of Q and K is one 8-byte load.  Row
//     strides are padded so that no fragment read has a bank conflict.  The
//     online softmax runs on the four threads of an mma quad (IEEE expf).
//     The tensor cores truncate the float32 sum of each mma, so no
//     accumulator chains long: scores sum 4 k-steps at a time and P·V one
//     key tile at a time from zero, each partial added in IEEE float32.
//     What limits it on the H100: mma.sync (not wgmma) peaks at about 300
//     TFLOP/s in TF32, so 3×TF32 cannot pass 100; with 254 registers a
//     thread only 8 warps fit an SM, too few to hide the latency of the
//     fragment reads and of the hi/lo splits each warp repeats for the
//     whole K and V tile (PERF.md §6).
//
// landmark_stats' W half (landmark_softmax_kernel) stays on IEEE FMA: it is
// 1.5% of the work, and the Newton–Schulz iteration that consumes W
// amplifies its error.
//
// Launch geometry: the rows a block (64 or 128 on the tensor-core sweep) are
// chosen by the measured autotune cache (kernel.py).  They decide which
// block computes a row, never a sum's order: a row's scores and accumulator
// are one warp's k-ordered sums over the same key tiles, the key tile is a
// function of the shape, and the key splits are fixed by the shape
// (kernel.py `plan`), so every candidate gives the same bits.  The decode
// sweep has one geometry ("8 rows a block": all of a problem's S ≤ 8 rows),
// and its key partition (splits, then warps) is fixed by the shape as well.
//
// Plain C interface, loaded with ctypes by kernel.py.  Each entry launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 256;   // 8 warps a block
constexpr int kTL = 32;         // keys a tile of the IEEE sweeps: one per lane
constexpr int kTLP = kTL + 1;   // padded row of the transposed key and score tiles
constexpr int kDVT = 128;       // value columns a block (more in grid.z chunks)
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-thread tiles of landmark_stats' W half (64 landmark rows a block):
// scores, RS rows × CS keys of the 64 × 32 tile.  Rows are strided by the
// number of thread rows, columns by the number of thread columns, so a warp
// reads neighbouring words of shared memory.
template <int BQ> struct Shape;
template <> struct Shape<64> { static constexpr int RS = 4, CS = 2; };

// Shared memory, in floats: Q (BQ × QS), Kᵀ (Dh × 33), a 32 × 128 tile the
// W half leaves unused, scores (BQ × 33), and the running max, denominator
// and rescale per row.
__host__ __device__ inline int q_stride(int Dh) { return Dh | 1; }
__host__ __device__ inline size_t smem_floats(int bq, int Dh) {
  return (size_t)bq * q_stride(Dh) + (size_t)Dh * kTLP + kTL * kDVT + bq * kTLP + 3 * bq;
}

// Load the block's BQ query rows (rows ≥ S are zero).
template <typename T, int BQ>
__device__ __forceinline__ void load_q(float* Qs, const T* __restrict__ q, int row0, int S,
                                       int Dh) {
  const int QS = q_stride(Dh);
  for (int e = threadIdx.x; e < BQ * Dh; e += kThreads) {
    const int r = e / Dh, k = e - r * Dh;
    Qs[r * QS + k] = row0 + r < S ? to_f32(q[(size_t)(row0 + r) * Dh + k]) : 0.0f;
  }
}

// Load keys key0 .. key0+31 transposed, (Dh, 32); keys ≥ Lk are zero.
template <typename T>
__device__ __forceinline__ void load_keys(float* KsT, const T* __restrict__ keys, int key0,
                                          int Lk, int Dh) {
  for (int e = threadIdx.x; e < kTL * Dh; e += kThreads) {
    const int c = e / Dh, k = e - c * Dh;
    KsT[k * kTLP + c] = key0 + c < Lk ? to_f32(keys[(size_t)(key0 + c) * Dh + k]) : 0.0f;
  }
}

// The BQ × 32 tile of q·kᵀ·scale (+ bias), masked, into Ps.  Keys ≥ Lk get
// −inf (weight exactly 0: they are not part of the input); keys ≥ mask_from
// get −1e30 in place of their logit (LA:105, LA:119).
template <int BQ>
__device__ __forceinline__ void score_tile(const float* Qs, const float* KsT, float* Ps,
                                           const float* bias, int key0, int Lk, int mask_from,
                                           int Dh, float scale) {
  using Sh = Shape<BQ>;
  constexpr int TXS = kTL / Sh::CS, TYS = BQ / Sh::RS;
  static_assert(TXS * TYS == kThreads, "score tile must use every thread");
  const int QS = q_stride(Dh);
  const int txs = threadIdx.x % TXS, tys = threadIdx.x / TXS;
  float s[Sh::RS][Sh::CS];
#pragma unroll
  for (int i = 0; i < Sh::RS; ++i)
#pragma unroll
    for (int j = 0; j < Sh::CS; ++j) s[i][j] = 0.0f;
  for (int k = 0; k < Dh; ++k) {
    float a[Sh::RS], b[Sh::CS];
#pragma unroll
    for (int i = 0; i < Sh::RS; ++i) a[i] = Qs[(tys + TYS * i) * QS + k];
#pragma unroll
    for (int j = 0; j < Sh::CS; ++j) b[j] = KsT[k * kTLP + txs + TXS * j];
#pragma unroll
    for (int i = 0; i < Sh::RS; ++i)
#pragma unroll
      for (int j = 0; j < Sh::CS; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int j = 0; j < Sh::CS; ++j) {
    const int c = txs + TXS * j, key = key0 + c;
    const float bj = (bias != nullptr && key < Lk) ? bias[key] : 0.0f;
#pragma unroll
    for (int i = 0; i < Sh::RS; ++i) {
      float v = -INFINITY;
      if (key < Lk) v = key < mask_from ? __fadd_rn(__fmul_rn(s[i][j], scale), bj) : kMasked;
      Ps[(tys + TYS * i) * kTLP + c] = v;
    }
  }
}

// One online-softmax step for the tile in Ps: per row, the new running max,
// the tile's exponentials in place, the rescale of the old terms, and the
// new denominator.  A warp takes rows w, w+8, ...; lane = key.
template <int BQ>
__device__ __forceinline__ void softmax_step(float* Ps, float* m_s, float* d_s, float* c_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const float v = Ps[r * kTLP + lane];
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, warp_max(v));
    const float p = expf(v - m_new);
    Ps[r * kTLP + lane] = p;
    const float sum = warp_sum(p);
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      c_s[r] = c;
      d_s[r] = d_s[r] * c + sum;
      m_s[r] = m_new;
    }
  }
}

// --------------------------------------------------------------------------
// The decode sweep (S ≤ 8 query rows a problem): attend_decode_kernel.
//
// Replaces LA:54 `landmark_attention` at S ≤ 8 (the G = 4 query rows of a
// GQA group at each decode step of the sketched cache) and serves the BmV
// half of LA:138 `landmark_stats` where L ≤ 8.  Bound by bytes: at the
// decode shape (P = 32 problems, L = 1024 slots, Dh = Dv = 128, float32) it
// reads 33.6 MB — 10.0 µs at 3.35 TB/s — and does 67 MFLOP, 1 µs at the
// float32 FMA rate.  Measured there (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py): 0.0125 ms of device time, 81% of the byte bound
// (2.7 TB/s), in one launch — against 0.0384 ms and two launches for the
// IEEE tile sweep it replaces (26%).
//
// Design, for the card's memory system:
//   * Every byte is read once, 16 bytes a lane.  A warp reads a whole key
//     row (and value row) a step: lane l takes head-dim elements 4l .. 4l+3
//     (of each 128-element half where Dh > 128) and value columns
//     col0 + 4l .. col0 + 4l+3, with one 16-byte load (float32) or 8-byte
//     load (bfloat16) each; rows that are not 16-byte aligned, or whose
//     width is not a multiple of 4, take element loads.  No integer division
//     in the address arithmetic.
//   * The problem's G query rows live in registers, split by lanes the same
//     way, so every key row read serves all G rows.
//   * A warp reads U keys at once (8 at the decode shape; fewer where the
//     rows or the head dim would spill registers, `Decode`): U key rows and
//     U value rows in flight, 8 KB a warp at the decode shape, before any of
//     them is consumed.  With two blocks of 8 warps on an SM (128 registers
//     a thread) that is up to 128 KB in flight per SM, against the ~25 KB
//     the card needs (3.35 TB/s × ~1 µs over 132 SMs).
//   * The last block's combine stages the splits' maxima and denominators
//     in shared memory with one round of loads and unrolls its loads of
//     their accumulators.  A first version whose combine waited on each
//     split's load in turn (and whose butterfly sat in local memory) took
//     0.0290 ms at 16 splits and 0.0200 ms at 4; this one 0.0169 and 0.0142
//     (scripts/bench_landmark.py --decode --plans, same card).
//   * The U·G partial dot products of a lane (32 at the decode shape) are
//     summed across the warp by a transposing butterfly (U·G − 1 shuffles
//     where a plain one would take 5 a dot), which leaves lane l with the
//     score of (row, key) = ((l >> SHIFT) / U, (l >> SHIFT) % U); the online
//     softmax then takes one expf a lane, and each weight is broadcast to
//     the warp for P·V.
//   * Keys are split across warps and blocks, never rows: warp w of block
//     (split s) takes keys [(s·W + w)·run, +run), run a multiple of U, and
//     keeps its own running max, denominator and G × 4-column accumulator a
//     lane.  A block merges its W warps in warp order through shared
//     memory; with more than one split it writes its partial to the
//     scratch, and the last block of the problem to arrive (an integer
//     arrival counter behind __threadfence, reset by that block) combines
//     the splits in split order.  One launch; no float atomics.
//   * The partition is kernel.py `plan`'s, a function of the shape alone,
//     so two runs give the same bits.
//   * Optionally (`lse` not null) each row's log-sum-exp, max + log(den),
//     from the values the output's division already holds: B·H floats for
//     a sharded sketched decode to combine its ranks' partials
//     (models/attention.py `_on_sketch_cache`).  No bit of `out` changes.
//
//   grid.x: splits of the key axis; grid.y: problem × value chunk of 128
//   columns; blockDim.x: 32 · W.
// --------------------------------------------------------------------------
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDecodeMaxWarps = 8;
constexpr int kDecodeMaxSplits = 64;  // kernel.py DECODE_MAX_SPLITS

// The G query rows (S rounded up to 1, 2, 4 or 8) a decode instantiation
// holds, with NCH halves of 128 head-dim elements a key row; U keys a warp
// reads at once: U·NCH ≤ 8 float4 registers of keys, U·G ≤ 32 dot products
// a lane, and 2 where the 8 rows' queries and accumulators already take 64
// registers (U divides kernel.py's runs of 8 keys); V = U·G scores a batch,
// lane l holding score l >> SHIFT after the butterfly; REC floats a partial
// (accumulator G × 128, then G maxima and G denominators), RS that rounded
// up to whole float4s.
__host__ __device__ constexpr int decode_batch_of(int G, int NCH) {
  return G == 8 ? 2 : (8 / NCH < 32 / G ? 8 / NCH : 32 / G);
}
template <int G, int NCH> struct Decode {
  static constexpr int U = decode_batch_of(G, NCH);
  static constexpr int V = U * G;
  static constexpr int SHIFT = V >= 32 ? 0 : V == 16 ? 1 : V == 8 ? 2 : 3;
  static constexpr int REC = G * (kDVT + 2);
  static constexpr int RS = (REC + 3) & ~3;
  static_assert(V >= 4 && V <= 32 && 8 % U == 0, "a batch's scores fill the warp");
};

__host__ __device__ inline int decode_rows(int S) {
  return S <= 1 ? 1 : S <= 2 ? 2 : S <= 4 ? 4 : 8;
}
__host__ __device__ inline int decode_batch(int S, int Dh) {
  return decode_batch_of(decode_rows(S), Dh > 128 ? 2 : 1);
}
// A block's shared memory: the warps' partials, or the last block's
// staging of the splits' maxima, denominators and weights and the rows'
// maxima.
template <int G, int NCH>
__host__ __device__ inline size_t decode_smem_bytes(int warps) {
  const size_t recs = (size_t)warps * Decode<G, NCH>::RS,
               stage = 3 * kDecodeMaxSplits * G + G;
  return (recs > stage ? recs : stage) * sizeof(float);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Whether rows of n elements from p take one load of 4 elements: n a
// multiple of 4 and p aligned to 4 elements (then every row is).
template <typename T>
__device__ __forceinline__ bool vec4(const T* p, int n) {
  return n % 4 == 0 && (reinterpret_cast<size_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

// Elements col .. col+3 of a row of n, widened to float32; those past n are
// 0.  VEC: one 16-byte (float32) or 8-byte (bfloat16) load; else elements.
template <bool VEC, typename T>
__device__ __forceinline__ float4 load4(const T* row, int col, int n) {
  if constexpr (VEC) {
    return col < n ? ld4(row + col) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = col + i < n ? to_f32(row[col + i]) : 0.0f;
    return make_float4(e[0], e[1], e[2], e[3]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// One step of the transposing butterfly over x[0 .. 2·HALF): a lane keeps
// the half named by its lane bit HALF << SHIFT and adds its partner's copy
// of it, then the next step halves again.
template <int HALF, int SHIFT, int V>
__device__ __forceinline__ void transpose_step(float (&x)[V], int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = (lane & (HALF << SHIFT)) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float keep = upper ? x[HALF + i] : x[i];
      const float send = upper ? x[i] : x[HALF + i];
      x[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, HALF << SHIFT));
    }
    transpose_step<HALF / 2, SHIFT, V>(x, lane);
  }
}

// The warp's sums of x[0 .. V) over its 32 lanes, transposed: after log2 V
// halving steps lane l holds the sum of index l >> SHIFT over the lanes of
// its step partners, and the remaining 5 − log2 V steps add the lanes that
// hold the same index (commutative, so those lanes agree bit for bit).
template <int V, int SHIFT>
__device__ __forceinline__ float transpose_sum(float (&x)[V], int lane) {
  transpose_step<V / 2, SHIFT, V>(x, lane);
  float v = x[0];
#pragma unroll
  for (int o = (1 << SHIFT) / 2; o >= 1; o /= 2) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One warp's walk over its keys k0 .. k1−1, U at a time, into its running
// max, denominator and accumulator (value columns col0 + 4·lane .. +3) of
// each row, the same in every lane.  VEC: key and value rows take one load
// of 4 elements (the branch is taken once, outside the loop).
template <typename T, int G, int NCH, bool VEC>
__device__ __forceinline__ void decode_walk(const float4 (&qv)[G][NCH], const T* keys,
                                            const T* vals, const float* bias, int k0, int k1,
                                            int Dh, int Dv, int col0, int mask_from,
                                            float scale, int lane, float (&m_run)[G],
                                            float (&d_run)[G], float4 (&acc)[G]) {
  using D = Decode<G, NCH>;
  constexpr int U = D::U, V = D::V, SHIFT = D::SHIFT;
  const int own = lane >> SHIFT, g_own = own / U, u_own = own % U;
  for (int b0 = k0; b0 < k1; b0 += U) {
    // U key rows and U value rows in flight before any is consumed; keys
    // past the end are zero (runs are whole batches, so only Lk cuts)
    float4 kr[U][NCH], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = b0 + u < k1;
      const T* kp = keys + (size_t)(b0 + u) * Dh;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        kr[u][c] = ok ? load4<VEC>(kp, 128 * c + 4 * lane, Dh)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      vr[u] = ok ? load4<VEC>(vals + (size_t)(b0 + u) * Dv, col0 + 4 * lane, Dv)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float x[V];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) s = dot4(qv[g][c], kr[u][c], s);
        x[g * U + u] = s;
      }
    const float dot = transpose_sum<V, SHIFT>(x, lane);
    // this lane's score: keys past the end get −inf (weight exactly 0), keys
    // ≥ mask_from the logit −1e30 (LA:105, LA:119)
    const int key = b0 + u_own;
    float sc = -INFINITY;
    if (key < k1) {
      const float b = bias != nullptr ? bias[key] : 0.0f;
      sc = key < mask_from ? __fadd_rn(__fmul_rn(dot, scale), b) : kMasked;
    }
    // the batch's max of each row over its U keys, then the new running max
    float mt = sc;
#pragma unroll
    for (int o = 1 << SHIFT; o < (U << SHIFT); o <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
    float mo = m_run[0];
#pragma unroll
    for (int g = 1; g < G; ++g)
      if (g_own == g) mo = m_run[g];
    const float mn_own = fmaxf(mo, mt);
    const float p_own = expf(sc - mn_own);
    // every lane: rescale the old terms of each row, then add the batch's
    // weights in key order
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mn = __shfl_sync(kFull, mn_own, (g * U) << SHIFT);
      const float c = expf(m_run[g] - mn);
      m_run[g] = mn;
      float d = __fmul_rn(d_run[g], c);
      float4 a = make_float4(acc[g].x * c, acc[g].y * c, acc[g].z * c, acc[g].w * c);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = __shfl_sync(kFull, p_own, (g * U + u) << SHIFT);
        d = __fadd_rn(d, p);
        a.x = fmaf(p, vr[u].x, a.x);
        a.y = fmaf(p, vr[u].y, a.y);
        a.z = fmaf(p, vr[u].z, a.z);
        a.w = fmaf(p, vr[u].w, a.w);
      }
      d_run[g] = d;
      acc[g] = a;
    }
  }
}

template <typename T, typename TO, int G, int NCH>
__global__ void __launch_bounds__(kDecodeMaxWarps * 32, 2)
    attend_decode_kernel(const T* __restrict__ q, const T* __restrict__ keys,
                         const T* __restrict__ vals, const float* __restrict__ bias,
                         TO* __restrict__ out, float* __restrict__ lse,
                         float* __restrict__ part, int* __restrict__ arrivals, int S, int Lk,
                         int Dh, int Dv, int mask_from, int run, float scale) {
  using D = Decode<G, NCH>;
  constexpr int REC = D::REC, RS = D::RS;
  extern __shared__ __align__(16) float dsm[];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int ndv = (Dv + kDVT - 1) / kDVT;
  const int z = blockIdx.y, prob = z / ndv, col0 = (z - prob * ndv) * kDVT;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int k0 = (split * nw + warp) * run, k1 = min(k0 + run, Lk);
  const bool vq = vec4(q, Dh), vkv = vec4(keys, Dh) && vec4(vals, Dv);
  q += (size_t)prob * S * Dh;
  keys += (size_t)prob * Lk * Dh;
  vals += (size_t)prob * Lk * Dv;
  if (bias != nullptr) bias += (size_t)prob * Lk;

  // this warp's running max, denominator and accumulator of each row
  float m_run[G], d_run[G];
  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    d_run[g] = 0.0f;
    acc[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (k0 < k1) {
    float4 qv[G][NCH];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const T* row = q + (size_t)g * Dh;
        const int col = 128 * c + 4 * lane;
        qv[g][c] = g >= S ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                   : vq   ? load4<true>(row, col, Dh)
                          : load4<false>(row, col, Dh);
      }
    if (vkv)
      decode_walk<T, G, NCH, true>(qv, keys, vals, bias, k0, k1, Dh, Dv, col0, mask_from,
                                   scale, lane, m_run, d_run, acc);
    else
      decode_walk<T, G, NCH, false>(qv, keys, vals, bias, k0, k1, Dh, Dv, col0, mask_from,
                                    scale, lane, m_run, d_run, acc);
  }

  // the warps' partials to shared memory (a warp with no keys: max −inf,
  // weight 0), then the block's, merged in warp order
  float* rec = dsm + warp * RS;
#pragma unroll
  for (int g = 0; g < G; ++g) reinterpret_cast<float4*>(rec + g * kDVT)[lane] = acc[g];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      rec[G * kDVT + g] = m_run[g];
      rec[G * kDVT + G + g] = d_run[g];
    }
  }
  __syncthreads();
  float* mine = nsplit > 1 ? part + ((size_t)z * nsplit + split) * REC : nullptr;
  for (int e = threadIdx.x; e < G * kDVT; e += blockDim.x) {
    const int g = e / kDVT, col = e % kDVT;
    float M = -INFINITY;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, dsm[w * RS + G * kDVT + g]);
    float den = 0.0f, a = 0.0f;
    for (int w = 0; w < nw; ++w) {
      const float* r = dsm + w * RS;
      const float wt = expf(r[G * kDVT + g] - M);
      den = fmaf(wt, r[G * kDVT + G + g], den);
      a = fmaf(wt, r[e], a);
    }
    if (mine == nullptr) {
      if (g < S && col0 + col < Dv) store(out + ((size_t)prob * S + g) * Dv + col0 + col, a / den);
      // each value chunk has the same scores: the first writes the row's lse
      if (lse != nullptr && g < S && col == 0 && col0 == 0)
        lse[(size_t)prob * S + g] = M + logf(den);
    } else {
      mine[e] = a;
      if (col == 0) {
        mine[G * kDVT + g] = M;
        mine[G * kDVT + G + g] = den;
      }
    }
  }
  if (mine == nullptr) return;

  // the last block of this problem and value chunk to arrive combines the
  // splits in split order and resets the counter for the next launch
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + z, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the splits' maxima and denominators staged in shared memory at once,
  // then each split's weight exp(m_s − max) for each row
  const float* all = part + (size_t)z * nsplit * REC;
  float* sm = dsm;
  float* sd = sm + nsplit * G;
  float* sw = sd + nsplit * G;
  float* sx = sw + nsplit * G;
  for (int i = threadIdx.x; i < nsplit * G; i += blockDim.x) {
    const float* r = all + (size_t)(i / G) * REC + G * kDVT + i % G;
    sm[i] = __ldcg(r);
    sd[i] = __ldcg(r + G);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nsplit * G; i += blockDim.x) {
    const int g = i % G;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, sm[s * G + g]);
    sw[i] = expf(sm[i] - M);
    if (i < G) sx[i] = M;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * kDVT; e += blockDim.x) {
    const int g = e / kDVT, col = e % kDVT;
    if (g >= S || col0 + col >= Dv) continue;
    float den = 0.0f, a = 0.0f;
    const float* r = all + e;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
      const float w = sw[s * G + g];
      den = fmaf(w, sd[s * G + g], den);
      a = fmaf(w, __ldcg(r + (size_t)s * REC), a);
    }
    store(out + ((size_t)prob * S + g) * Dv + col0 + col, a / den);
    if (lse != nullptr && col == 0 && col0 == 0) lse[(size_t)prob * S + g] = sx[g] + logf(den);
  }
  if (threadIdx.x == 0) arrivals[z] = 0;
}

// Combine the splits of one output row in split order:
// out = Σ_s e^{m_s − m} acc_s / Σ_s e^{m_s − m} d_s, m = max_s m_s.
template <typename TO>
__global__ void attend_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pd,
                                      const float* __restrict__ pacc, TO* __restrict__ out,
                                      int rows, int Dv, int nsplit) {
  const size_t row = blockIdx.x;
  float mg = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mg = fmaxf(mg, pm[s * (size_t)rows + row]);
  float den = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t at = s * (size_t)rows + row;
    den += pd[at] * expf(pm[at] - mg);
  }
  for (int col = threadIdx.x; col < Dv; col += blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t at = s * (size_t)rows + row;
      a += pacc[at * Dv + col] * expf(pm[at] - mg);
    }
    store(out + row * Dv + col, a / den);
  }
}

// --------------------------------------------------------------------------
// landmark_stats' W half: W = softmax(q̃ k̃ᵀ/√Dh) per problem, landmark
// columns ≥ l_valid masked to −1e30 (LA:105).  Once per problem, not once
// per split of S.  One block takes 64 landmark rows and walks all L key
// columns in tiles: the scaled logits go to W in global memory while the
// running max and denominator are kept per row, and a second pass over the
// block's own rows turns them into exp(s − m) / d.
// --------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    landmark_softmax_kernel(const T* __restrict__ qt, const T* __restrict__ kt,
                            float* __restrict__ W, int L, int Dh, int l_valid, float scale) {
  constexpr int BQ = 64;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KsT = Qs + BQ * q_stride(Dh);
  float* Ps = KsT + Dh * kTLP + kTL * kDVT;
  float* m_s = Ps + BQ * kTLP;
  float* d_s = m_s + BQ;
  float* c_s = d_s + BQ;
  const int prob = blockIdx.z, row0 = blockIdx.x * BQ;
  qt += (size_t)prob * L * Dh;
  kt += (size_t)prob * L * Dh;
  W += (size_t)prob * L * L;

  load_q<T, BQ>(Qs, qt, row0, L, Dh);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = -INFINITY;
    d_s[r] = 0.0f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int key0 = 0; key0 < L; key0 += kTL) {
    __syncthreads();
    load_keys<T>(KsT, kt, key0, L, Dh);
    __syncthreads();
    score_tile<BQ>(Qs, KsT, Ps, nullptr, key0, L, l_valid, Dh, scale);
    __syncthreads();
    for (int r = warp; r < BQ; r += kThreads / 32)
      if (row0 + r < L && key0 + lane < L)
        W[(size_t)(row0 + r) * L + key0 + lane] = Ps[r * kTLP + lane];
    softmax_step<BQ>(Ps, m_s, d_s, c_s);
  }
  __syncthreads();  // every logit of the block's rows is in W
  for (int r = warp; r < BQ; r += kThreads / 32) {
    if (row0 + r >= L) continue;
    float* w = W + (size_t)(row0 + r) * L;
    const float m = m_s[r], d = d_s[r];
    for (int c = lane; c < L; c += 32) w[c] = expf(w[c] - m) / d;
  }
}

// --------------------------------------------------------------------------
// The tensor-core sweep (S > 8): 3×TF32 mma.sync, cp.async-staged key tiles.
// --------------------------------------------------------------------------

// k-steps (of 8) a tensor-core accumulator of the scores chains before its
// sum is added to the scores in IEEE float32.  The tensor cores truncate
// each step's float32 sum, so a long chain drifts toward zero: one chain
// over a 16,384-key split of landmark_stats was off by 1.4e-4 of max|BmV|
// on the H100.  The P·V product chains one key tile's k-steps.
constexpr int kChunk = 4;

// The head dim padded to the mma's k of 8, and to whole score chunks (the
// padding is zero; the chunk loop then has a fixed trip count).
__host__ __device__ inline int pad8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int pad_chunk(int x) {
  return (x + 8 * kChunk - 1) / (8 * kChunk) * (8 * kChunk);
}

// Row strides, in elements, of the shared Q and K tiles (head dim
// contiguous) and of the V tile (value columns contiguous).  An 8-byte read
// of Q or K by the four threads of each of eight quads (float32: 32-bit
// words at g·stride + 2t, two phases of 16 threads) is conflict-free when
// the stride is 8 mod 32 words; a 4-byte read of two bfloat16 when it is 4
// mod 32 words.  V is read at rows 2t and 2t + 1, columns g: conflict-free
// at 4 mod 32 words (float32) or 8 mod 32 halves (bfloat16).  Every stride
// keeps rows 16-byte aligned for cp.async.
template <typename T>
__host__ __device__ inline int k_stride(int Dh) {
  constexpr int a = sizeof(T) == 4 ? 32 : 64;
  return (pad_chunk(Dh) + a - 1) / a * a + 8;
}
template <typename T>
__host__ __device__ constexpr int v_stride() {
  return sizeof(T) == 4 ? kDVT + 4 : kDVT + 8;
}

// 64-key tiles unless a float32 head dim above 192 would overflow shared
// memory at 64 rows a block; a function of the shape alone (kernel.py
// `key_tile` is the same rule), so every rows-a-block candidate walks the
// same tiles.
template <typename T>
__host__ __device__ inline int mma_key_tile(int Dh) {
  return (sizeof(T) == 2 || pad8(Dh) <= 192) ? 64 : 32;
}

// Shared memory of one block: the Q tile and two stages of K and V.
template <typename T>
__host__ __device__ inline size_t mma_smem_bytes(int bq, int kt, int Dh) {
  return sizeof(T) * ((size_t)(bq + 2 * kt) * k_stride<T>(Dh) + (size_t)2 * kt * v_stride<T>());
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2⁻²²|x|): hi = tf32(x), lo = tf32(x − hi) (x − hi exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a·b on the tensor cores: a 16 × 8 (row), b 8 × 8 (col), TF32 in,
// float32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring elements of a shared tile, widened.
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// 16 bytes from global to shared memory without the registers; src_bytes =
// 0 fills the 16 bytes with zeros (a row or columns past the input's end).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Stage rows row0 .. row0+nr−1, columns col0 .. col0+w−1 of a (rows, ld)
// row-major matrix into dst (nr × stride); rows ≥ rows and columns ≥ cols
// are zero.  vec: 16-byte cp.async copies (cols and ld multiples of 16
// bytes, src 16-byte aligned, w a multiple of 16 bytes); else plain loads
// and stores, element by element.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int stride, const T* __restrict__ src,
                                           int ld, int row0, int nr, int rows, int col0,
                                           int w, int cols, bool vec) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int r = threadIdx.x >> 5; r < nr; r += nw)
      for (int c = lane * V; c < w; c += 32 * V) {
        const bool ok = row0 + r < rows && col0 + c < cols;
        cp_async16(dst + r * stride + c,
                   ok ? src + (size_t)(row0 + r) * ld + col0 + c : src, ok);
      }
  } else {
    for (int r = threadIdx.x >> 5; r < nr; r += nw)
      for (int c = lane; c < w; c += 32) {
        const bool ok = row0 + r < rows && col0 + c < cols;
        dst[r * stride + c] = ok ? src[(size_t)(row0 + r) * ld + col0 + c] : zero<T>();
      }
  }
}

template <typename T>
__device__ __forceinline__ bool can_vec(const T* p, int width) {
  return width % (16 / (int)sizeof(T)) == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
}

// --------------------------------------------------------------------------
//   grid.x: row blocks of 16·NW query rows; grid.y: splits of the key axis
//   (tiles_per_split tiles of KT keys each); grid.z: problem × value chunk.
//   Warp w owns rows 16w .. 16w+15 of the block; lane = 4g + t.
//
// With one split the block writes out = acc / d in the output type; with
// more it writes its (max, denominator, unnormalized accumulator) to the
// scratch for attend_combine_kernel.
// --------------------------------------------------------------------------
template <typename T, typename TO, int NW, int KT>
__global__ void __launch_bounds__(NW * 32, 1)
    attend_mma_kernel(const T* __restrict__ q, const T* __restrict__ keys,
                      const T* __restrict__ vals, const float* __restrict__ bias,
                      TO* __restrict__ out, float* __restrict__ pm, float* __restrict__ pd,
                      float* __restrict__ pacc, int P, int S, int Lk, int Dh, int Dv,
                      int mask_from, int tiles_per_split, float scale) {
  constexpr int BQ = 16 * NW, NT = KT / 8, NV = kDVT / 8, VS = v_stride<T>();
  constexpr bool kSplit = sizeof(T) == 4;   // float32 operands carry a lo part
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int ks = k_stride<T>(Dh), Dhp = pad_chunk(Dh);
  T* Qs = reinterpret_cast<T*>(mma_smem);
  T* Ks = Qs + BQ * ks;    // two stages of KT × ks
  T* Vs = Ks + 2 * KT * ks;  // two stages of KT × VS

  const int ndv = (Dv + kDVT - 1) / kDVT;
  const int prob = blockIdx.z / ndv, col0 = (blockIdx.z % ndv) * kDVT;
  const int row0 = blockIdx.x * BQ, split = blockIdx.y, nsplit = gridDim.y;
  const int ntiles = (Lk + KT - 1) / KT;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, ntiles);
  const bool vq = can_vec(q, Dh), vk = can_vec(keys, Dh), vv = can_vec(vals, Dv);
  q += (size_t)prob * S * Dh;
  keys += (size_t)prob * Lk * Dh;
  vals += (size_t)prob * Lk * Dv;
  if (bias != nullptr) bias += (size_t)prob * Lk;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  stage_tile(Qs, ks, q, Dh, row0, BQ, S, 0, Dhp, Dh, vq);
  auto stage = [&](int tile, int s) {
    stage_tile(Ks + s * KT * ks, ks, keys, Dh, tile * KT, KT, Lk, 0, Dhp, Dh, vk);
    stage_tile(Vs + s * KT * VS, VS, vals, Dv, tile * KT, KT, Lk, col0, kDVT, Dv, vv);
    cp_async_commit();
  };
  stage(tile0, 0);

  // rows g and g + 8 of the warp's 16: running max and denominator; the
  // accumulator of the block's kDVT value columns in the mma's C layout
  float m_run[2] = {-INFINITY, -INFINITY}, d_run[2] = {0.0f, 0.0f};
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const T* Qw = Qs + warp * 16 * ks;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int s = (tile - tile0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile is in shared memory; every warp is done with tile − 1
    if (tile + 1 < tile1) stage(tile + 1, s ^ 1);
    const T* Kt = Ks + s * KT * ks;
    const T* Vt = Vs + s * KT * VS;

    // scores: 16 rows × KT keys, k-step by k-step over the head dim; the
    // k index t of a fragment is head dim k0 + 2t, t + 4 is k0 + 2t + 1.
    // Each chunk of kChunk k-steps is summed from zero and added to the
    // scores in IEEE float32.
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    for (int c0 = 0; c0 < Dhp; c0 += 8 * kChunk) {
      float part[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        const int k0 = c0 + 8 * kk;
        const float2 x0 = ld_pair(Qw + g * ks + k0 + 2 * t);
        const float2 x1 = ld_pair(Qw + (g + 8) * ks + k0 + 2 * t);
        const float xa[4] = {x0.x, x1.x, x0.y, x1.y};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kSplit) split_tf32(xa[e], ah[e], al[e]);
          else ah[e] = __float_as_uint(xa[e]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 y = ld_pair(Kt + (8 * j + g) * ks + k0 + 2 * t);
          if constexpr (kSplit) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(y.x, bh0, bl0);
            split_tf32(y.y, bh1, bl1);
            mma(part[j], al, bh0, bh1);
            mma(part[j], ah, bl0, bl1);
            mma(part[j], ah, bh0, bh1);
          } else {
            mma(part[j], ah, __float_as_uint(y.x), __float_as_uint(y.y));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = __fadd_rn(sc[j][e], part[j][e]);
    }

    // mask, scale, bias; element e of n-tile j is row g + 8(e >> 1), key
    // key0 + 8j + 2t + (e & 1)
    const int key0 = tile * KT;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * t + (e & 1);
        float v = -INFINITY;
        if (key < Lk) {
          const float b = bias != nullptr ? bias[key] : 0.0f;
          v = key < mask_from ? __fadd_rn(__fmul_rn(sc[j][e], scale), b) : kMasked;
        }
        sc[j][e] = v;
        mt[e >> 1] = fmaxf(mt[e >> 1], v);
      }
    float c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      mt[r] = fmaxf(m_run[r], mt[r]);
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - mt[e >> 1]);
        sum[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      c[r] = expf(m_run[r] - mt[r]);
      d_run[r] = d_run[r] * c[r] + sum[r];
      m_run[r] = mt[r];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= c[e >> 1];

    // acc += P·V: k-step j takes keys 8j .. 8j+7 with k index t ↔ key
    // 8j + 2t and t + 4 ↔ 8j + 2t + 1, so the scores' C fragment of n-tile
    // j is the A fragment as it stands.  Half the value n-tiles at a time:
    // each of their accumulators sums the tile's keys from zero, and is
    // then added to acc in IEEE float32.
#pragma unroll
    for (int n0 = 0; n0 < NV; n0 += NV / 2) {
      float part[NV / 2][4];
#pragma unroll
      for (int n = 0; n < NV / 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float pa[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(pa[e], ph[e], pl[e]);
        const T* v0 = Vt + (8 * j + 2 * t) * VS + 8 * n0 + g;
#pragma unroll
        for (int n = 0; n < NV / 2; ++n) {
          const float b0 = to_f32(v0[8 * n]), b1 = to_f32(v0[VS + 8 * n]);
          if constexpr (kSplit) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(b0, bh0, bl0);
            split_tf32(b1, bh1, bl1);
            mma(part[n], pl, bh0, bh1);
            mma(part[n], ph, bl0, bl1);
            mma(part[n], ph, bh0, bh1);
          } else {
            mma(part[n], pl, __float_as_uint(b0), __float_as_uint(b1));
            mma(part[n], ph, __float_as_uint(b0), __float_as_uint(b1));
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NV / 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] = __fadd_rn(acc[n0 + n][e], part[n][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const size_t base = (size_t)prob * S + row;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * n + 2 * t + e;
        if (col >= Dv) continue;
        const float a = acc[n][2 * r + e];
        if (nsplit == 1)
          store(out + base * Dv + col, a / d_run[r]);
        else
          pacc[((size_t)split * P * S + base) * Dv + col] = a;
      }
    if (nsplit > 1 && col0 == 0 && t == 0) {
      const size_t at = (size_t)split * P * S + base;
      pm[at] = m_run[r];
      pd[at] = d_run[r];
    }
  }
}

template <typename TO>
cudaError_t combine(const float* pm, const float* pd, const float* pacc, void* out, int rows,
                    int Dv, int nsplit, cudaStream_t stream) {
  attend_combine_kernel<TO><<<rows, 128, 0, stream>>>(pm, pd, pacc, static_cast<TO*>(out),
                                                      rows, Dv, nsplit);
  return cudaGetLastError();
}

// Allow `bytes` of dynamic shared memory to the kernel `kern` on the current
// device.  The attribute belongs to the function on a device, so it is set
// once for each (kernel, device) and raised only when a launch needs more;
// launches within 48 KB need none.
cudaError_t allow_smem(const void* kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  struct Allowed {
    const void* kern;
    int dev;
    size_t bytes;
  };
  static std::mutex lock;
  static std::vector<Allowed> allowed;
  const std::lock_guard<std::mutex> hold(lock);
  for (Allowed& a : allowed)
    if (a.kern == kern && a.dev == dev) {
      if (a.bytes >= bytes) return cudaSuccess;
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e == cudaSuccess) a.bytes = bytes;
      return e;
    }
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed.push_back({kern, dev, bytes});
  return e;
}

// The decode sweep (S ≤ 8): G rows a warp, `warps` warps a block, `run` keys
// a warp, nsplit ≤ kDecodeMaxSplits splits; `part` and `arrivals` serve
// nsplit > 1.  Its shared memory stays within 48 KB (8 warps × 4.2 KB at
// G = 8).
template <typename T, typename TO, int G, int NCH>
cudaError_t launch_decode_rows(const void* q, const void* keys, const void* vals,
                               const float* bias, void* out, float* lse, float* part,
                               int* arrivals, int P,
                               int S, int Lk, int Dh, int Dv, int n_valid, int nsplit, int run,
                               int warps, float scale, cudaStream_t stream) {
  const int ndv = (Dv + kDVT - 1) / kDVT;
  attend_decode_kernel<T, TO, G, NCH><<<dim3(nsplit, P * ndv), 32 * warps,
                                        decode_smem_bytes<G, NCH>(warps), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys), static_cast<const T*>(vals), bias,
      static_cast<TO*>(out), lse, part, arrivals, S, Lk, Dh, Dv, n_valid, run, scale);
  return cudaGetLastError();
}

template <typename T, typename TO, int NCH>
cudaError_t launch_decode_dh(const void* q, const void* keys, const void* vals,
                             const float* bias, void* out, float* lse, float* part,
                             int* arrivals, int P,
                             int S, int Lk, int Dh, int Dv, int n_valid, int nsplit, int run,
                             int warps, float scale, cudaStream_t s) {
  switch (decode_rows(S)) {
    case 1:
      return launch_decode_rows<T, TO, 1, NCH>(q, keys, vals, bias, out, lse, part, arrivals, P, S,
                                               Lk, Dh, Dv, n_valid, nsplit, run, warps, scale, s);
    case 2:
      return launch_decode_rows<T, TO, 2, NCH>(q, keys, vals, bias, out, lse, part, arrivals, P, S,
                                               Lk, Dh, Dv, n_valid, nsplit, run, warps, scale, s);
    case 4:
      return launch_decode_rows<T, TO, 4, NCH>(q, keys, vals, bias, out, lse, part, arrivals, P, S,
                                               Lk, Dh, Dv, n_valid, nsplit, run, warps, scale, s);
    default:
      return launch_decode_rows<T, TO, 8, NCH>(q, keys, vals, bias, out, lse, part, arrivals, P, S,
                                               Lk, Dh, Dv, n_valid, nsplit, run, warps, scale, s);
  }
}

template <typename T, typename TO>
cudaError_t launch_decode(const void* q, const void* keys, const void* vals, const float* bias,
                          void* out, float* lse, float* part, int* arrivals, int P, int S, int Lk,
                          int Dh,
                          int Dv, int n_valid, int nsplit, int run, int warps, float scale,
                          cudaStream_t s) {
  if (S < 1 || S > 8 || Dh < 1 || Dh > 256 || warps < 1 || warps > kDecodeMaxWarps ||
      nsplit < 1 || nsplit > kDecodeMaxSplits || run < 1 || run % decode_batch(S, Dh) != 0 ||
      (nsplit > 1 && (part == nullptr || arrivals == nullptr)))
    return cudaErrorInvalidValue;
  if (Dh > 128)
    return launch_decode_dh<T, TO, 2>(q, keys, vals, bias, out, lse, part, arrivals, P, S, Lk, Dh,
                                      Dv, n_valid, nsplit, run, warps, scale, s);
  return launch_decode_dh<T, TO, 1>(q, keys, vals, bias, out, lse, part, arrivals, P, S, Lk, Dh, Dv,
                                    n_valid, nsplit, run, warps, scale, s);
}

// The tensor-core sweep (S > 8): 16·NW rows a block, KT-key tiles.
template <typename T, typename TO, int NW, int KT>
cudaError_t launch_mma(const void* q, const void* keys, const void* vals, const float* bias,
                       void* out, float* pm, float* pd, float* pacc, int P, int S, int Lk,
                       int Dh, int Dv, int n_valid, int nsplit, int tiles_per_split,
                       float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * NW;
  const size_t smem = mma_smem_bytes<T>(BQ, KT, Dh);
  auto kern = attend_mma_kernel<T, TO, NW, KT>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  const int ndv = (Dv + kDVT - 1) / kDVT;
  const dim3 grid((S + BQ - 1) / BQ, nsplit, P * ndv);
  kern<<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys), static_cast<const T*>(vals), bias,
      static_cast<TO*>(out), pm, pd, pacc, P, S, Lk, Dh, Dv, n_valid, tiles_per_split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  return combine<TO>(pm, pd, pacc, out, P * S, Dv, nsplit, stream);
}

// The tensor-core sweep with NW warps (64 or 128 rows a block) at the shape's
// key tile.
template <typename T, typename TO, int NW>
cudaError_t launch_mma_tiled(const void* q, const void* keys, const void* vals,
                             const float* bias, void* out, float* pm, float* pd, float* pacc,
                             int P, int S, int Lk, int Dh, int Dv, int n_valid, int nsplit,
                             int tiles_per_split, float scale, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (mma_key_tile<T>(Dh) == 32)
      return launch_mma<T, TO, NW, 32>(q, keys, vals, bias, out, pm, pd, pacc, P, S, Lk, Dh,
                                       Dv, n_valid, nsplit, tiles_per_split, scale, s);
  }
  return launch_mma<T, TO, NW, 64>(q, keys, vals, bias, out, pm, pd, pacc, P, S, Lk, Dh, Dv,
                                   n_valid, nsplit, tiles_per_split, scale, s);
}

// The sweep with bq rows a block: 8 takes the decode sweep (`per` keys a warp,
// `warps` warps a block, the split partials in `scratch` and `arrivals`), 64
// and 128 the tensor-core sweep (4 or 8 warps, `per` key tiles a split; its
// partial maxima, denominators and accumulators at the head of `scratch`).
template <typename T, typename TO>
cudaError_t dispatch_attend(int bq, const void* q, const void* keys, const void* vals,
                            const float* bias, void* out, float* lse, float* scratch,
                            int* arrivals, int P, int S, int Lk, int Dh, int Dv, int n_valid,
                            int nsplit, int per, int warps, float scale, cudaStream_t s) {
  if (bq == 8)
    return launch_decode<T, TO>(q, keys, vals, bias, out, lse, scratch, arrivals, P, S, Lk, Dh,
                                Dv, n_valid, nsplit, per, warps, scale, s);
  if (lse != nullptr) return cudaErrorInvalidValue;  // the decode sweep's output alone
  const size_t rows = (size_t)nsplit * P * S;
  float* pm = scratch;
  float* pd = scratch != nullptr ? pm + rows : nullptr;
  float* pacc = scratch != nullptr ? pd + rows : nullptr;
  if (bq == 64)
    return launch_mma_tiled<T, TO, 4>(q, keys, vals, bias, out, pm, pd, pacc, P, S, Lk, Dh,
                                      Dv, n_valid, nsplit, per, scale, s);
  if (bq == 128)
    return launch_mma_tiled<T, TO, 8>(q, keys, vals, bias, out, pm, pd, pacc, P, S, Lk, Dh,
                                      Dv, n_valid, nsplit, per, scale, s);
  return cudaErrorInvalidValue;
}

// Whether a kernel with `threads` threads a block and `smem` bytes of
// dynamic shared memory can launch on the current device.
cudaError_t check_launch(const cudaFuncAttributes& attr, int threads, size_t smem, int* fits) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *fits = attr.maxThreadsPerBlock >= threads && smem + attr.sharedSizeBytes <= (size_t)optin;
  return cudaSuccess;
}

template <typename T, typename TO, int NW, int KT>
cudaError_t check_mma(int Dh, int* fits) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, attend_mma_kernel<T, TO, NW, KT>);
  if (e != cudaSuccess) return e;
  return check_launch(attr, NW * 32, mma_smem_bytes<T>(16 * NW, KT, Dh), fits);
}

template <typename T, typename TO, int NW>
cudaError_t check_mma_tiled(int Dh, int* fits) {
  if constexpr (sizeof(T) == 4) {
    if (mma_key_tile<T>(Dh) == 32) return check_mma<T, TO, NW, 32>(Dh, fits);
  }
  return check_mma<T, TO, NW, 64>(Dh, fits);
}

// Whether the sweep with bq rows a block and head dim Dh can launch on the
// current device: its shared memory within the opt-in limit, and its
// registers leaving room for the block's threads.
template <typename T, typename TO>
cudaError_t check_attend(int bq, int Dh, int* fits) {
  if (bq == 64) return check_mma_tiled<T, TO, 4>(Dh, fits);
  if (bq == 128) return check_mma_tiled<T, TO, 8>(Dh, fits);
  if (bq != 8) {
    *fits = 0;
    return cudaSuccess;
  }
  cudaFuncAttributes attr;
  const cudaError_t e =
      Dh > 128 ? cudaFuncGetAttributes(&attr, attend_decode_kernel<T, TO, 8, 2>)
               : cudaFuncGetAttributes(&attr, attend_decode_kernel<T, TO, 8, 1>);
  if (e != cudaSuccess) return e;
  return check_launch(attr, kDecodeMaxWarps * 32,
                      Dh > 128 ? decode_smem_bytes<8, 2>(kDecodeMaxWarps)
                               : decode_smem_bytes<8, 1>(kDecodeMaxWarps),
                      fits);
}

template <typename T>
cudaError_t launch_stats(const void* qt, const void* kt, const void* k, const void* v, float* W,
                         float* BmV, float* scratch, int* arrivals, int P, int L, int S, int Dh,
                         int Dv, int n_valid, int l_valid, int nsplit, int per, int warps,
                         int bs, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(64, Dh) * sizeof(float);
  auto kern = landmark_softmax_kernel<T>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((L + 63) / 64, 1, P), kThreads, smem, stream>>>(
      static_cast<const T*>(qt), static_cast<const T*>(kt), W, L, Dh, l_valid, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return dispatch_attend<T, float>(bs, qt, k, v, nullptr, BmV, nullptr, scratch, arrivals, P, L,
                                   S, Dh, Dv, n_valid, nsplit, per, warps, scale, stream);
}

}  // namespace

extern "C" {

// out (P, S, Dv) in q's type from q (P, S, Dh), kt (P, L, Dh), M (P, L, Dv),
// bias (P, L) float32 or null; lse (P, S) float32 or null: each row's
// log-sum-exp of its logits, the decode sweep's alone (bq 8; it takes the
// block's or the combine's max and denominator, and changes no bit of
// out).  bq is 8 where S ≤ 8 (the decode sweep: `per`
// keys a warp, `warps` warps a block; scratch holds P·⌈Dv/128⌉·nsplit
// partials of ⌈S⌉₂·130 floats, ⌈S⌉₂ = S rounded up to 1, 2, 4 or 8, and
// arrivals P·⌈Dv/128⌉ int counters at 0), else 64 or 128 (the tensor-core
// sweep: `per` tiles of kernel.py's key_tile a split; scratch holds maxima
// and denominators (nsplit, P, S) and accumulators (nsplit, P, S, Dv);
// arrivals unused).  Scratch and arrivals are unused when nsplit = 1.
int repro_landmark_attention(const void* q, const void* kt, const void* M, const float* bias,
                             void* out, float* lse, float* scratch, int* arrivals, int P, int S,
                             int L, int Dh, int Dv, int nsplit, int per, int warps, int bq,
                             float scale, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_attend<__nv_bfloat16, __nv_bfloat16>(bq, q, kt, M, bias, out, lse,
                                                             scratch, arrivals, P, S, L, Dh, Dv,
                                                             L, nsplit, per, warps, scale, s)
             : dispatch_attend<float, float>(bq, q, kt, M, bias, out, lse, scratch, arrivals, P,
                                             S, L, Dh, Dv, L, nsplit, per, warps, scale, s);
}

// W (P, L, L) and BmV (P, L, Dv) float32 from qt, kt (P, L, Dh), k (P, S, Dh),
// v (P, S, Dv).  Scratch and arrivals as above with L rows over S keys; bs
// landmark rows a block of the BmV sweep (8 where L ≤ 8, else 64 or 128).
int repro_landmark_stats(const void* qt, const void* kt, const void* k, const void* v, float* W,
                         float* BmV, float* scratch, int* arrivals, int P, int L, int S, int Dh,
                         int Dv, int n_valid, int l_valid, int nsplit, int per, int warps,
                         int bs, float scale, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_stats<__nv_bfloat16>(qt, kt, k, v, W, BmV, scratch, arrivals, P, L,
                                               S, Dh, Dv, n_valid, l_valid, nsplit, per, warps,
                                               bs, scale, s)
                 : launch_stats<float>(qt, kt, k, v, W, BmV, scratch, arrivals, P, L, S, Dh,
                                       Dv, n_valid, l_valid, nsplit, per, warps, bs, scale, s);
}

// *fits = whether the sweep with bq rows a block and head dim Dh can launch
// here; variant 0: float32 in and out, 1: bfloat16 in and out, 2: bfloat16
// in, float32 out (landmark_stats' BmV).
int repro_landmark_check(int bq, int Dh, int variant, int* fits) {
  if (variant == 1) return check_attend<__nv_bfloat16, __nv_bfloat16>(bq, Dh, fits);
  if (variant == 2) return check_attend<__nv_bfloat16, float>(bq, Dh, fits);
  return check_attend<float, float>(bq, Dh, fits);
}

}  // extern "C"
