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
// B·H in accum_attention).  Inputs are float32 or bfloat16; every product
// and sum is IEEE float32 (no TF32), as the TPU kernels' f32 accumulation.
// Masked logits are −1e30, never −inf, so a row whose every entry is masked
// gets uniform weights, as in the reference, and no NaN.  Keys past the end
// of the input (the ragged last tile) get weight exactly 0.
//
// The TPU kernel kept k̃ and M whole in VMEM (LA:80–82).  At the decode shape
// (L = 1024, Dh = Dv = 128, float32) they are 512 KB each against a block's
// 227 KB of shared memory, so here every problem walks its keys in tiles of
// 32 with an online softmax (running max, denominator and accumulator per
// query row), flash-attention style.  Blocks run in parallel and in no
// order, so where one problem's keys are split across blocks (flash-decoding:
// the decode shape has only G = 4 query rows per problem, 32 problems at
// batch 4, far too few blocks for 132 SMs) each block writes its partial
// (max, denominator, accumulator) to a scratch and a second launch combines
// the pieces in split order.  No float atomics: every sum has one owner and
// a fixed order, so results are the same bits from run to run.
//
// Bound on the H100:
//   decode landmark_attention: bytes.  k̃ and M are read once (34 MB at batch
//     4), about 2 MFLOP per problem; the split over keys gives 512 blocks.
//   F-stage landmark_attention and landmark_stats: float32 operations,
//     2·S·L·(Dh + Dv) per problem (≈ 550 GFLOP at B·H = 32, S = 32768,
//     L = 1024), against 67 TFLOP/s outside the tensor cores.  Each block
//     holds BQ query rows (64 unless the autotune cache chose 8 or 128), so a
//     key tile loaded once serves BQ rows; at BQ = 64 each thread computes a
//     4 × 2 tile of scores and a 4 × 8 tile of the accumulator from shared
//     memory.  Simple, not yet fast: the scores' inner loop issues 6 shared
//     loads per 8 multiply-adds at BQ = 64.
//
// Launch geometry: BQ (the query rows a block, landmark rows in
// landmark_stats' BmV sweep) is a template argument in {8, 64, 128}, chosen
// by the measured autotune cache (kernel.py).  It decides which block
// computes a row, never a sum's order: every score is one thread's k-ordered
// sum, every row's softmax walks the same key tiles with the same warp
// reductions, and the key splits are fixed by the shape (kernel.py `plan`),
// so every BQ gives the same bits.
//
// Plain C interface, loaded with ctypes by kernel.py.  Each entry launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // 8 warps a block
constexpr int kTL = 32;         // keys a tile: one per lane in the softmax step
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

// Per-thread tiles for BQ query rows a block.  Scores: RS rows × CS keys of
// the BQ × 32 tile; accumulator: RA rows × CA columns of the BQ × 128 tile.
// Rows are strided by the number of thread rows, columns by the number of
// thread columns, so a warp reads neighbouring words of shared memory.
template <int BQ> struct Shape;
template <> struct Shape<128> { static constexpr int RS = 8, CS = 2, RA = 8, CA = 8; };
template <> struct Shape<64> { static constexpr int RS = 4, CS = 2, RA = 4, CA = 8; };
template <> struct Shape<8> { static constexpr int RS = 1, CS = 1, RA = 1, CA = 4; };

// Shared memory, in floats: Q (BQ × QS), Kᵀ (Dh × 33), M (32 × 128),
// scores (BQ × 33), and the running max, denominator and rescale per row.
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
// The online-softmax sweep shared by both kernels (landmark_attention's
// whole work, landmark_stats' BmV half).
//
//   grid.x: row blocks of BQ query rows; grid.y: splits of the key axis
//   (tiles_per_split tiles of 32 keys each); grid.z: problem × value chunk.
//
// With one split the block writes out = acc / d in the output type; with
// more it writes its (max, denominator, unnormalized accumulator) to the
// scratch for attend_combine_kernel.
// --------------------------------------------------------------------------
template <typename T, typename TO, int BQ>
__global__ void __launch_bounds__(kThreads)
    attend_partial_kernel(const T* __restrict__ q, const T* __restrict__ keys,
                          const T* __restrict__ vals, const float* __restrict__ bias,
                          TO* __restrict__ out, float* __restrict__ pm, float* __restrict__ pd,
                          float* __restrict__ pacc, int P, int S, int Lk, int Dh, int Dv,
                          int n_valid, int tiles_per_split, float scale) {
  using Sh = Shape<BQ>;
  constexpr int TXA = kDVT / Sh::CA, TYA = BQ / Sh::RA;
  static_assert(TXA * TYA == kThreads, "accumulator tile must use every thread");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KsT = Qs + BQ * q_stride(Dh);
  float* Ms = KsT + Dh * kTLP;
  float* Ps = Ms + kTL * kDVT;
  float* m_s = Ps + BQ * kTLP;
  float* d_s = m_s + BQ;
  float* c_s = d_s + BQ;

  const int ndv = (Dv + kDVT - 1) / kDVT;
  const int prob = blockIdx.z / ndv, col0 = (blockIdx.z % ndv) * kDVT;
  const int row0 = blockIdx.x * BQ, split = blockIdx.y, nsplit = gridDim.y;
  const int ntiles = (Lk + kTL - 1) / kTL;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, ntiles);
  q += (size_t)prob * S * Dh;
  keys += (size_t)prob * Lk * Dh;
  vals += (size_t)prob * Lk * Dv;
  if (bias != nullptr) bias += (size_t)prob * Lk;

  load_q<T, BQ>(Qs, q, row0, S, Dh);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = -INFINITY;
    d_s[r] = 0.0f;
  }
  const int txa = threadIdx.x % TXA, tya = threadIdx.x / TXA;
  float acc[Sh::RA][Sh::CA];
#pragma unroll
  for (int i = 0; i < Sh::RA; ++i)
#pragma unroll
    for (int j = 0; j < Sh::CA; ++j) acc[i][j] = 0.0f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int key0 = tile * kTL;
    __syncthreads();  // the previous tile's Kᵀ, M and scores are consumed
    load_keys<T>(KsT, keys, key0, Lk, Dh);
    for (int e = threadIdx.x; e < kTL * kDVT; e += kThreads) {
      const int t = e / kDVT, c = e - t * kDVT;
      const int key = key0 + t, col = col0 + c;
      Ms[e] = (key < Lk && col < Dv) ? to_f32(vals[(size_t)key * Dv + col]) : 0.0f;
    }
    __syncthreads();
    score_tile<BQ>(Qs, KsT, Ps, bias, key0, Lk, n_valid, Dh, scale);
    __syncthreads();
    softmax_step<BQ>(Ps, m_s, d_s, c_s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < Sh::RA; ++i) {
      const float c = c_s[tya + TYA * i];
#pragma unroll
      for (int j = 0; j < Sh::CA; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int t = 0; t < kTL; ++t) {
      float a[Sh::RA], b[Sh::CA];
#pragma unroll
      for (int i = 0; i < Sh::RA; ++i) a[i] = Ps[(tya + TYA * i) * kTLP + t];
#pragma unroll
      for (int j = 0; j < Sh::CA; ++j) b[j] = Ms[t * kDVT + txa + TXA * j];
#pragma unroll
      for (int i = 0; i < Sh::RA; ++i)
#pragma unroll
        for (int j = 0; j < Sh::CA; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < Sh::RA; ++i) {
    const int r = tya + TYA * i, row = row0 + r;
    if (row >= S) continue;
    const size_t base = (size_t)prob * S + row;
#pragma unroll
    for (int j = 0; j < Sh::CA; ++j) {
      const int col = col0 + txa + TXA * j;
      if (col >= Dv) continue;
      if (nsplit == 1)
        store(out + base * Dv + col, acc[i][j] / d_s[r]);
      else
        pacc[((size_t)split * P * S + base) * Dv + col] = acc[i][j];
    }
  }
  if (nsplit > 1 && col0 == 0) {
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      if (row0 + r >= S) continue;
      const size_t at = (size_t)split * P * S + (size_t)prob * S + row0 + r;
      pm[at] = m_s[r];
      pd[at] = d_s[r];
    }
  }
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

template <typename T, typename TO, int BQ>
cudaError_t launch_attend(const void* q, const void* keys, const void* vals, const float* bias,
                          void* out, float* pm, float* pd, float* pacc, int P, int S, int Lk,
                          int Dh, int Dv, int n_valid, int nsplit, int tiles_per_split,
                          float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(BQ, Dh) * sizeof(float);
  auto kern = attend_partial_kernel<T, TO, BQ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int ndv = (Dv + kDVT - 1) / kDVT;
  const dim3 grid((S + BQ - 1) / BQ, nsplit, P * ndv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys), static_cast<const T*>(vals), bias,
      static_cast<TO*>(out), pm, pd, pacc, P, S, Lk, Dh, Dv, n_valid, tiles_per_split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  attend_combine_kernel<TO><<<P * S, 128, 0, stream>>>(pm, pd, pacc, static_cast<TO*>(out),
                                                      P * S, Dv, nsplit);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t dispatch_attend(int bq, const void* q, const void* keys, const void* vals,
                            const float* bias, void* out, float* pm, float* pd, float* pacc,
                            int P, int S, int Lk, int Dh, int Dv, int n_valid, int nsplit,
                            int tiles_per_split, float scale, cudaStream_t s) {
  if (bq == 8)
    return launch_attend<T, TO, 8>(q, keys, vals, bias, out, pm, pd, pacc, P, S, Lk, Dh, Dv,
                                   n_valid, nsplit, tiles_per_split, scale, s);
  if (bq == 128)
    return launch_attend<T, TO, 128>(q, keys, vals, bias, out, pm, pd, pacc, P, S, Lk, Dh, Dv,
                                     n_valid, nsplit, tiles_per_split, scale, s);
  return launch_attend<T, TO, 64>(q, keys, vals, bias, out, pm, pd, pacc, P, S, Lk, Dh, Dv,
                                  n_valid, nsplit, tiles_per_split, scale, s);
}

// Whether the sweep with BQ = bq and head dim Dh can launch on the current
// device: its shared memory within the opt-in limit, and its registers
// leaving room for kThreads threads a block.
template <typename T, typename TO>
cudaError_t check_attend(int bq, int Dh, int* fits) {
  cudaFuncAttributes attr;
  cudaError_t e;
  if (bq == 8) e = cudaFuncGetAttributes(&attr, attend_partial_kernel<T, TO, 8>);
  else if (bq == 64) e = cudaFuncGetAttributes(&attr, attend_partial_kernel<T, TO, 64>);
  else if (bq == 128) e = cudaFuncGetAttributes(&attr, attend_partial_kernel<T, TO, 128>);
  else {
    *fits = 0;
    return cudaSuccess;
  }
  if (e != cudaSuccess) return e;
  int dev = 0, optin = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_floats(bq, Dh) * sizeof(float) + attr.sharedSizeBytes;
  *fits = attr.maxThreadsPerBlock >= kThreads && smem <= (size_t)optin;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_stats(const void* qt, const void* kt, const void* k, const void* v, float* W,
                         float* BmV, float* pm, float* pd, float* pacc, int P, int L, int S,
                         int Dh, int Dv, int n_valid, int l_valid, int nsplit,
                         int tiles_per_split, int bs, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(64, Dh) * sizeof(float);
  auto kern = landmark_softmax_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((L + 63) / 64, 1, P), kThreads, smem, stream>>>(
      static_cast<const T*>(qt), static_cast<const T*>(kt), W, L, Dh, l_valid, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return dispatch_attend<T, float>(bs, qt, k, v, nullptr, BmV, pm, pd, pacc, P, L, S, Dh, Dv,
                                   n_valid, nsplit, tiles_per_split, scale, stream);
}

}  // namespace

extern "C" {

// out (P, S, Dv) in q's type from q (P, S, Dh), kt (P, L, Dh), M (P, L, Dv),
// bias (P, L) float32 or null.  pm, pd (nsplit, P, S) and pacc (nsplit, P, S,
// Dv) float32 are scratch, unused when nsplit = 1.  bq is 8, 64 or 128.
int repro_landmark_attention(const void* q, const void* kt, const void* M, const float* bias,
                             void* out, float* pm, float* pd, float* pacc, int P, int S, int L,
                             int Dh, int Dv, int nsplit, int tiles_per_split, int bq,
                             float scale, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_attend<__nv_bfloat16, __nv_bfloat16>(bq, q, kt, M, bias, out, pm, pd,
                                                             pacc, P, S, L, Dh, Dv, L, nsplit,
                                                             tiles_per_split, scale, s)
             : dispatch_attend<float, float>(bq, q, kt, M, bias, out, pm, pd, pacc, P, S, L, Dh,
                                             Dv, L, nsplit, tiles_per_split, scale, s);
}

// W (P, L, L) and BmV (P, L, Dv) float32 from qt, kt (P, L, Dh), k (P, S, Dh),
// v (P, S, Dv).  Scratch as above with L rows; nsplit ≥ 2 splits S; bs (8,
// 64 or 128) landmark rows a block of the BmV sweep.
int repro_landmark_stats(const void* qt, const void* kt, const void* k, const void* v, float* W,
                         float* BmV, float* pm, float* pd, float* pacc, int P, int L, int S,
                         int Dh, int Dv, int n_valid, int l_valid, int nsplit,
                         int tiles_per_split, int bs, float scale, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_stats<__nv_bfloat16>(qt, kt, k, v, W, BmV, pm, pd, pacc, P, L, S, Dh,
                                               Dv, n_valid, l_valid, nsplit, tiles_per_split,
                                               bs, scale, s)
                 : launch_stats<float>(qt, kt, k, v, W, BmV, pm, pd, pacc, P, L, S, Dh, Dv,
                                       n_valid, l_valid, nsplit, tiles_per_split, bs, scale, s);
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
