// Accumulation-sketch application kernels for Hopper (sm_90a).
//
// Seven kernels replace the TPU's Pallas kernels in
// src/repro/kernels/accum_apply/kernel.py (AA below).  The sketch S has m
// non-zeros per column, given by idx/coef of shape (m, d):
//
//   S[:, j] = Σ_i coef[i, j] · e_{idx[i, j]}
//
// The TPU kernels turned every application of S into a dense MXU product
// against a one-hot (N, bd) block of S (AA:49 `_coef_block`), O(R·N·d) work
// for an O(R·m·d) gather.  These kernels gather the m·d needed entries
// directly and keep only the semantics.  Every sum runs in a fixed order
// (i = 0..m-1, then k = 0..p-1), with no atomics, so results are the same
// bits from run to run.  Inputs are float32 or bfloat16; every sum is float32.
//
// An index outside [0, N) reads nothing and poisons its output with NaN, so
// a bad sketch shows in the result instead of reading out of bounds.
//
// Launch geometry: the rows a block takes are a runtime argument of
// matfree_apply and of the column gather (kernel.py's ``bm``), chosen by the
// measured autotune cache (autotune.py).  A block's threads and registers
// do not depend on it (the sorted gather's value tile may hold fewer rows),
// and each output element keeps its one owner and its order of summation, so
// every row count gives the same bits.
//
// Plain C interface, loaded with ctypes by kernel.py.  Each entry launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ex2.approx and rsqrt.approx on the SFU, with denormal results flushed to 0
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The kernel value from the expanded squared distance of the scaled points,
// q = scale²·d2 before its clamp at 0 (kernel.py ``matfree_fold``; its
// constants computed in float64 and rounded once).  Gaussian: scale² =
// log2(e)/(2·bw²), k = 2^(−q).  Laplacian and Matérn: scale = log2(e)·a
// (a = 1/bw, √3/bw or √5/bw), s = −√q = −log2(e)·a·r, and
// k = (1 + p1·s + p2·s²)·2^s (p1 = −ln 2, p2 = (ln 2)²/3 for ν = 2.5: the
// closed forms' (1 + √3 r/bw) and (1 + √5 r/bw + 5r²/(3bw²)) prefactors in
// s).  The reference's √(d2 + 1e-30) becomes q·rsqrt(max(q, 1e-30)): the two
// differ below 1e-15, where both round k to 1.
template <bool GAUSS>
__device__ __forceinline__ float folded_value(float q, float p1, float p2) {
  if constexpr (GAUSS) return ex2_approx(fminf(-q, 0.0f));
  q = fmaxf(q, 0.0f);
  const float s = -q * rsqrt_approx(fmaxf(q, 1e-30f));
  return fmaf(fmaf(p2, s, p1), s, 1.0f) * ex2_approx(s);
}

// float4 records a landmark takes in shared memory: p ≤ 3 one, p ≤ 7 two,
// larger p none (the general layout).  kernel.py ``matfree_floats`` mirrors it.
__host__ __device__ constexpr int matfree_quads(int p) { return p <= 3 ? 1 : (p <= 7 ? 2 : 0); }

// --------------------------------------------------------------------------
// matfree_apply — replaces AA:474 `matfree_apply`.
//
// out[r, j] = Σ_{i<m} coef[i, j] · k(X[r], L[i·d + j]),   out (n, d) float32
//
// Bound on the H100: bytes.  The inputs are X (n·p) and the m·d landmark
// rows; the output is n·d float32, which dominates (512 MiB at n = 2^21,
// d = 64: 0.168 ms at 3.35 TB/s).  The m·d·n evaluations cost one ex2 each
// on the SFU (16 a clock an SM: 0.13 ms at 1.98 GHz for the Gaussian; rsqrt
// + ex2 for the others) and, at p = 3, FMUL + 2 FFMA + 2 FADD + clamp + FFMA
// on the FP32 pipe (10 operations, an FMA counting 2: 0.08 ms).
//
// Design: no division and no expf in the loop.  Both points are scaled by
// the kernel's `scale` as they are read, so that the expanded distance of
// the scaled points is the exponent itself.  The prologue stores each
// landmark as (−2·l_0, …, −2·l_{p−1}, ‖l‖²) of the scaled landmark, one float4
// for p ≤ 3 (two for p ≤ 7), its coefficient beside it; each row keeps its
// scaled x and ‖x‖² in registers.  Then q = Σ_k (−2·l_k)·x_k + (‖l‖² + ‖x‖²)
// is an FMA chain from the first product and two adds, and the Gaussian's
// value 2^(−max(q, 0)) one clamp and one ex2 (folded_value).  A row and a
// landmark drawn from it are scaled alike, the factor −2 is exact, and each
// sum runs in the order of the norms' own chains, so such a self pair gets
// q = 0 exactly, as with the expanded distance of the reference (a fold of
// the scale into the landmarks alone rounded there, and the Laplacian's cusp
// magnified it).  A block of 32 × 8 threads takes `rows` rows of X (512 at
// large n, kernel.py ``matfree_rows``, unless the autotune cache chose
// otherwise: the prologue is paid once a block) and a group of `jc` output
// columns (grid.y; all d columns when the group's landmarks fit 48 KB).  A
// warp takes RB = 8 rows at a time with its lanes along the output columns:
// each LDS.128 of a landmark serves 8 rows held in registers, all lanes read
// the same rows of X (broadcasts), and they write neighbouring elements of C,
// so every store is coalesced.  The sum over i < m runs in order in one
// thread, so every row count gives the same bits.  Larger p keeps the
// weights transposed, (p, nl), and reads x from global memory, one row at a
// time.  The Cmat of the TPU kernel (ops.expand_coef) is never built: the
// sum over i < m is the contraction.
// --------------------------------------------------------------------------
template <typename T, int Q, int RB, bool GAUSS>
__global__ void __launch_bounds__(256) matfree_apply_kernel(
    const T* __restrict__ X, const T* __restrict__ L, const float* __restrict__ coef,
    float* __restrict__ out, int n, int p, int m, int d, int jc, float scale, float p1,
    float p2, int rows) {
  constexpr int W = Q > 0 ? 4 * Q : 1;   // floats of a landmark record (Q > 0)
  constexpr int PR = Q > 0 ? W - 1 : 1;  // x held in registers (Q > 0)
  extern __shared__ __align__(16) float smem[];
  const int j0 = blockIdx.y * jc;
  const int jw = min(jc, d - j0);
  const int nl = m * jw;  // landmark l = i·jw + jj  ↔  row i·d + j0 + jj of L
  // Q > 0: record l at sW[l·W]: −2·l, zeros, ‖l‖² last, of the scaled
  // landmark.  Q = 0: −2·l transposed (p, nl), then ‖l‖² (nl).  Then the
  // coefficients (nl).
  float* sW = smem;
  float* sB = sW + (size_t)nl * p;
  float* sC = Q > 0 ? sW + (size_t)nl * W : sB + nl;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int l = tid; l < nl; l += nthreads) {
    const int i = l / jw, jj = l - i * jw;
    const T* lr = L + (size_t)(i * d + j0 + jj) * p;
    float l2 = 0.0f;
    for (int k = 0; k < p; ++k) {
      const float v = scale * to_f32(lr[k]);
      l2 = fmaf(v, v, l2);
      if constexpr (Q > 0) sW[l * W + k] = -2.0f * v;
      else sW[k * nl + l] = -2.0f * v;
    }
    if constexpr (Q > 0) {
      for (int k = p; k < W - 1; ++k) sW[l * W + k] = 0.0f;
      sW[l * W + W - 1] = l2;
    } else {
      sB[l] = l2;
    }
    sC[l] = coef[i * d + j0 + jj];
  }
  __syncthreads();

  const int r_end = (int)min((long long)n, (long long)(blockIdx.x + 1) * rows);
  for (int rb = blockIdx.x * rows + threadIdx.y * RB; rb < r_end; rb += blockDim.y * RB) {
    float x[RB][PR];
    float xs[RB];  // ‖x‖² of the scaled row
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const T* xr = X + (size_t)min(rb + q, r_end - 1) * p;
      float s = 0.0f;
      if constexpr (Q > 0) {
#pragma unroll
        for (int k = 0; k < PR; ++k) {
          const float v = k < p ? scale * to_f32(xr[k]) : 0.0f;
          x[q][k] = v;
          s = fmaf(v, v, s);
        }
      } else {
        for (int k = 0; k < p; ++k) {
          const float v = scale * to_f32(xr[k]);
          s = fmaf(v, v, s);
        }
      }
      xs[q] = s;
    }
    for (int jj = threadIdx.x; jj < jw; jj += blockDim.x) {
      float acc[RB];
#pragma unroll
      for (int q = 0; q < RB; ++q) acc[q] = 0.0f;
      for (int i = 0; i < m; ++i) {
        const int l = i * jw + jj;
        const float c = sC[l];
        if constexpr (Q > 0) {
          float w[W];
#pragma unroll
          for (int u = 0; u < Q; ++u) {
            const float4 v = reinterpret_cast<const float4*>(sW)[l * Q + u];
            w[4 * u] = v.x;
            w[4 * u + 1] = v.y;
            w[4 * u + 2] = v.z;
            w[4 * u + 3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < RB; ++q) {
            float t = w[0] * x[q][0];
#pragma unroll
            for (int k = 1; k < PR; ++k) t = fmaf(w[k], x[q][k], t);
            t += w[W - 1] + xs[q];
            acc[q] = fmaf(c, folded_value<GAUSS>(t, p1, p2), acc[q]);
          }
        } else {
          const T* xr = X + (size_t)min(rb, r_end - 1) * p;
          float t = 0.0f;
          for (int k = 0; k < p; ++k) t = fmaf(sW[k * nl + l], scale * to_f32(xr[k]), t);
          t += sB[l] + xs[0];
          acc[0] = fmaf(c, folded_value<GAUSS>(t, p1, p2), acc[0]);
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (rb + q < r_end) out[(size_t)(rb + q) * d + j0 + jj] = acc[q];
    }
  }
}

template <typename T, int Q, bool GAUSS>
cudaError_t launch_matfree(const void* X, const void* L, const float* coef, float* out, int n,
                           int p, int m, int d, int jc, float scale, float p1, float p2,
                           int rows, cudaStream_t stream) {
  const size_t smem = (size_t)m * jc * (Q > 0 ? 4 * Q + 1 : p + 2) * sizeof(float);
  // eight rows per warp step where x is held in registers
  auto kern = matfree_apply_kernel<T, Q, (Q > 0 ? 8 : 1), GAUSS>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + rows - 1) / rows, (d + jc - 1) / jc);
  kern<<<grid, dim3(32, 8), smem, stream>>>(static_cast<const T*>(X), static_cast<const T*>(L),
                                            coef, out, n, p, m, d, jc, scale, p1, p2, rows);
  return cudaGetLastError();
}

template <typename T, bool GAUSS>
cudaError_t dispatch_quads(const void* X, const void* L, const float* coef, float* out, int n,
                           int p, int m, int d, int jc, float scale, float p1, float p2,
                           int rows, cudaStream_t s) {
  switch (matfree_quads(p)) {
    case 1: return launch_matfree<T, 1, GAUSS>(X, L, coef, out, n, p, m, d, jc, scale, p1, p2, rows, s);
    case 2: return launch_matfree<T, 2, GAUSS>(X, L, coef, out, n, p, m, d, jc, scale, p1, p2, rows, s);
    default: return launch_matfree<T, 0, GAUSS>(X, L, coef, out, n, p, m, d, jc, scale, p1, p2, rows, s);
  }
}

template <typename T>
cudaError_t dispatch_matfree(const void* X, const void* L, const float* coef, float* out, int n,
                             int p, int m, int d, int jc, int gauss, float scale, float p1,
                             float p2, int rows, cudaStream_t s) {
  return gauss ? dispatch_quads<T, true>(X, L, coef, out, n, p, m, d, jc, scale, p1, p2, rows, s)
               : dispatch_quads<T, false>(X, L, coef, out, n, p, m, d, jc, scale, p1, p2, rows, s);
}

// --------------------------------------------------------------------------
// accum_apply_left — replaces AA:229 `accum_apply_left`.
//
// out[j, col] = Σ_{i<m} coef[i, j] · M[idx[i, j], col],   out (d, c) float32
//
// Bound on the H100: launch latency.  It reads only the m·d gathered rows of
// M (82 KB at m = 4, d = c = 64), far below what one launch costs.
//
// Design: one block per output row j and column tile of c; thread `col`
// walks i = 0..m-1 in order and reads row idx[i, j] of M along c, so a warp
// reads 32 neighbouring elements.  The sum stays in a register and is written
// once.  One pass, no reduction across blocks.
// --------------------------------------------------------------------------
template <typename T>
__global__ void accum_apply_left_kernel(const T* __restrict__ M, const int* __restrict__ idx,
                                        const float* __restrict__ coef, float* __restrict__ out,
                                        int N, int c, int m, int d) {
  const int j = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= c) return;
  float acc = 0.0f;
  for (int i = 0; i < m; ++i) {
    const int row = idx[i * d + j];
    const float v = (unsigned)row < (unsigned)N ? to_f32(M[(size_t)row * c + col]) : __int_as_float(0x7fc00000);
    acc += coef[i * d + j] * v;
  }
  out[(size_t)j * c + col] = acc;
}

template <typename T>
cudaError_t launch_left(const void* M, const int* idx, const float* coef, float* out, int N, int c,
                        int m, int d, cudaStream_t stream) {
  const int threads = c >= 128 ? 128 : ((c + 31) / 32) * 32;
  const dim3 grid(d, (c + threads - 1) / threads);
  accum_apply_left_kernel<T><<<grid, threads, 0, stream>>>(static_cast<const T*>(M), idx, coef,
                                                           out, N, c, m, d);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// The column gather, shared by accum_sketch_both, accum_apply,
// accum_step_slab and accum_grow_slabs:
//
//   G[r, j] = Σ_{i<m} coef[i, j] · K[r, idx[i, j]]          (float32)
//   C32[r, j] = G[r, j]                       where C32 is given
//   Cout[r, j] = a·Cin[r, j] + G[r, j]        where Cin is given, else G,
//                                             in Cout's type, where given
//
// a·Cin is rounded before G is added (no fused multiply-add), the order of
// the TPU kernels (AA:272, AA:344).  Cout may be Cin itself: each element is
// read and written by one thread, so the rescale is safe in place.
//
// Bound on the H100: sectors.  It needs the R·m·d entries of K at the
// sampled columns and writes R·d outputs, but the gathered entries lie in
// separate 32-byte sectors, so the card moves up to 8 times the needed bytes
// of K (16 times in bfloat16): the distinct sectors of a row's sampled
// columns, R times.  Random sectors come at about 30 G/s, sectors read in
// ascending order along a row at about 48 G/s where a row has 1024 of them
// (scripts/sector_probe.cu; chip_smoke.py prints both bounds).
//
// Design, for GATHER_SORTED_MIN ≤ m·d ≤ GATHER_SORTED_MAX: each block sorts
// the launch's m·d (column, slot) pairs once in shared memory (a bitonic
// sort of 64-bit keys, column above slot).  It then takes its `rows` rows (64
// unless the autotune cache chose otherwise) in tiles of GATHER_TILE / (m·d)
// rows: every thread issues GATHER_UNROLL loads before it stores any, the
// lanes of a warp walk a row's sorted columns, so its loads ascend along the
// row, and each value lands in a shared-memory tile at its (i, j) slot.  A
// warp then takes a row of the tile at a time with its lanes along j, sums
// its m values in order (the same `acc += coef·v` chain as the row-at-a-time
// kernel below) and writes, so the reads of Cin and the writes are
// coalesced.  The order of the loads changes no sum: both kernels give the
// same bits.  An index outside [0, N) sorts last and gives NaN without a
// load.  Other m·d take the row-at-a-time kernel below (idx and coef staged
// in shared memory where they fit 48 KB): below 256 columns a row the sort
// bought 1% at 128 and cost 7% at 64 (B = 2 and 1 at d = 64, float32, on
// the H100).  One pass over K, no reduction across threads or blocks.
// --------------------------------------------------------------------------
constexpr int GATHER_SORTED_MIN = 256;   // m·d of the sorted gather: from …
constexpr int GATHER_SORTED_MAX = 1024;  // … to
constexpr int GATHER_TILE = 4096;        // values a block holds at a time (16 KB)
constexpr int GATHER_UNROLL = 8;         // loads a thread issues before it stores
constexpr int GATHER_THREADS = 256;

__host__ __device__ inline int pow2_at_least(int v) {
  int q = 1;
  while (q < v) q <<= 1;
  return q;
}

// rows of a tile of the sorted gather
__host__ __device__ inline int gather_tile_rows(int md, int rows) {
  const int t = GATHER_TILE / md < rows ? GATHER_TILE / md : rows;
  return t > 1 ? t : 1;
}

template <typename T, typename TO>
__global__ void __launch_bounds__(GATHER_THREADS) sketch_gather_kernel(
    const T* __restrict__ K, const int* __restrict__ idx, const float* __restrict__ coef,
    const float* Cin, float a, float* __restrict__ C32, TO* Cout, int R, int N, int m, int d,
    int rows) {
  extern __shared__ __align__(16) unsigned long long skey[];
  const int md = m * d;
  const int np2 = pow2_at_least(md);
  float* sF = reinterpret_cast<float*>(skey + np2);
  float* sV = sF + md;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < np2; t += GATHER_THREADS) {
    skey[t] = t < md ? ((unsigned long long)(unsigned)idx[t] << 32) | (unsigned)t : ~0ull;
    if (t < md) sF[t] = coef[t];
  }
  __syncthreads();
  for (int k = 2; k <= np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < np2; t += GATHER_THREADS) {
        const int u = t ^ j;
        if (u > t) {
          const unsigned long long x = skey[t], y = skey[u];
          if ((x > y) == ((t & k) == 0)) {
            skey[t] = y;
            skey[u] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  const int tr = gather_tile_rows(md, rows);
  const int r0 = blockIdx.x * rows;
  const int r1 = (int)min((long long)R, (long long)r0 + rows);
  // a thread's first element of a tile, row·md + s, and its step
  const int row0 = tid / md, s0 = tid - row0 * md;
  const int dr = GATHER_THREADS / md, ds = GATHER_THREADS - dr * md;
  for (int rt = r0; rt < r1; rt += tr) {
    const int nr = min(tr, r1 - rt);
    const T* Kt = K + (size_t)rt * N;
    int row = row0, s = s0;
    while (row < nr) {
      float v[GATHER_UNROLL];
      int dst[GATHER_UNROLL];
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) {
        dst[u] = -1;
        if (row < nr) {
          const unsigned long long key = skey[s];
          const unsigned col = (unsigned)(key >> 32);
          dst[u] = row * md + (int)(unsigned)key;
          v[u] = col < (unsigned)N ? to_f32(Kt[(size_t)row * N + col])
                                   : __int_as_float(0x7fc00000);
        }
        row += dr;
        s += ds;
        if (s >= md) {
          s -= md;
          ++row;
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u)
        if (dst[u] >= 0) sV[dst[u]] = v[u];
    }
    __syncthreads();
    for (int rr = threadIdx.y; rr < nr; rr += blockDim.y) {
      const float* vr = sV + rr * md;
      for (int j = threadIdx.x; j < d; j += blockDim.x) {
        float acc = 0.0f;
        for (int i = 0; i < m; ++i) acc += sF[i * d + j] * vr[i * d + j];
        const size_t o = (size_t)(rt + rr) * d + j;
        if (C32 != nullptr) C32[o] = acc;
        if (Cout != nullptr)
          store(Cout + o, Cin != nullptr ? __fadd_rn(__fmul_rn(a, Cin[o]), acc) : acc);
      }
    }
    __syncthreads();
  }
}

// The row-at-a-time gather, for m·d above GATHER_SORTED_MAX: a warp takes
// one row at a time with its lanes along j and reads its m terms in order.
template <typename T, typename TO>
__global__ void sketch_gather_rows_kernel(const T* __restrict__ K, const int* __restrict__ idx,
                                          const float* __restrict__ coef, const float* Cin,
                                          float a, float* __restrict__ C32, TO* Cout, int R,
                                          int N, int m, int d, int staged, int rows) {
  extern __shared__ int sbuf[];
  const int md = m * d;
  const int* I = idx;
  const float* F = coef;
  if (staged) {
    int* sI = sbuf;
    float* sF = reinterpret_cast<float*>(sbuf + md);
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int t = tid; t < md; t += blockDim.x * blockDim.y) {
      sI[t] = idx[t];
      sF[t] = coef[t];
    }
    __syncthreads();
    I = sI;
    F = sF;
  }
  const int r0 = blockIdx.x * rows;
  const int r1 = (int)min((long long)R, (long long)r0 + rows);
  for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const T* Kr = K + (size_t)r * N;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      float acc = 0.0f;
      for (int i = 0; i < m; ++i) {
        const int col = I[i * d + j];
        const float v = (unsigned)col < (unsigned)N ? to_f32(Kr[col]) : __int_as_float(0x7fc00000);
        acc += F[i * d + j] * v;
      }
      const size_t o = (size_t)r * d + j;
      if (C32 != nullptr) C32[o] = acc;
      if (Cout != nullptr)
        store(Cout + o, Cin != nullptr ? __fadd_rn(__fmul_rn(a, Cin[o]), acc) : acc);
    }
  }
}

template <typename T, typename TO>
cudaError_t launch_gather(const void* K, const int* idx, const float* coef, const float* Cin,
                          float a, float* C32, TO* Cout, int R, int N, int m, int d, int rows,
                          cudaStream_t stream) {
  const int md = m * d;
  const dim3 grid((R + rows - 1) / rows);
  if (GATHER_SORTED_MIN <= md && md <= GATHER_SORTED_MAX) {
    const size_t smem = (size_t)pow2_at_least(md) * sizeof(unsigned long long) +
                        (size_t)md * sizeof(float) * (1 + gather_tile_rows(md, rows));
    sketch_gather_kernel<T, TO><<<grid, dim3(32, GATHER_THREADS / 32), smem, stream>>>(
        static_cast<const T*>(K), idx, coef, Cin, a, C32, Cout, R, N, m, d, rows);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)md * (sizeof(int) + sizeof(float));
  const int staged = smem <= 48 * 1024;
  sketch_gather_rows_kernel<T, TO><<<grid, dim3(32, 8), staged ? smem : 0, stream>>>(
      static_cast<const T*>(K), idx, coef, Cin, a, C32, Cout, R, N, m, d, staged, rows);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// accum_sketch_both — replaces AA:164 `accum_sketch_both`.
//
// C = K S (R, d) and W = SᵀC (d, d), with W folded from the float32 C before
// C is cast to K's dtype (AA:140-160, ref.py sketch_both_ref).
//
// Design: two launches, no atomics.  (1) The gather writes C in float32 and,
// for bfloat16 K, its bfloat16 cast in the same pass.  (2) The left kernel
// above on the float32 C gives W: it reads only the m·d gathered rows of C.
// The TPU kernel fused both steps into one grid sweep because its grid ran
// in order on one core and could carry W in scratch; here the W step touches
// only m·d rows, so a second small launch costs little and keeps the
// reduction deterministic.
// --------------------------------------------------------------------------
template <typename T>
cudaError_t launch_both(const void* K, const int* idx, const float* coef, float* C32, void* Cout,
                        float* W, int R, int N, int m, int d, int rows, cudaStream_t stream) {
  const cudaError_t e = launch_gather<T, T>(K, idx, coef, nullptr, 0.0f, C32,
                                            static_cast<T*>(Cout), R, N, m, d, rows, stream);
  if (e != cudaSuccess) return e;
  return launch_left<float>(C32, idx, coef, W, R, d, m, d, stream);
}

// --------------------------------------------------------------------------
// accum_apply — replaces AA:84 `accum_apply`.
//
// out = K S (R, d) for rectangular K (R, N), summed in float32 and cast once
// to K's dtype.  One launch of the gather for any N: the TPU's chunk scan
// over N (ops.py MAX_COLS) exists for its VMEM and has no counterpart here.
// --------------------------------------------------------------------------
template <typename T>
cudaError_t launch_apply(const void* K, const int* idx, const float* coef, void* out, int R,
                         int N, int m, int d, int rows, cudaStream_t stream) {
  return launch_gather<T, T>(K, idx, coef, nullptr, 0.0f, nullptr, static_cast<T*>(out), R, N,
                             m, d, rows, stream);
}

// --------------------------------------------------------------------------
// accum_step_slab — replaces AA:277 `accum_step_slab`.
//
// out = a·Cin + K·T̃ (R, d) float32 for one slab (idx/coef of shape (1, d)).
// One launch of the gather with m = 1.  Bound on the H100: launch latency at
// the path's R = 8192 (6.3 MB in all, 1.9 µs at 3.35 TB/s).
// --------------------------------------------------------------------------
template <typename T>
cudaError_t launch_step(const void* K, const int* idx, const float* coef, const float* Cin,
                        float a, float* out, int R, int N, int d, int rows, cudaStream_t stream) {
  return launch_gather<T, float>(K, idx, coef, Cin, a, nullptr, out, R, N, 1, d, rows, stream);
}

// --------------------------------------------------------------------------
// accum_grow_slabs — replaces AA:370 `accum_grow_slabs`.
//
// For the B-slab block T (idx/coef of shape (B, d)) and G = K·T in float32:
//   C_new = a·Cin + G (R, d) float32,  TᵀG (d, d),  TᵀC = TᵀCin (d, d).
//
// Design: three launches on one stream, no atomics.  (1) The left kernel on
// Cin gives TᵀC first, so C_new may be written over Cin.  (2) The gather
// writes C_new and G (float32 scratch, R·d): TᵀG needs G itself, because
// C_new − a·Cin loses precision where a ≠ 0.  (3) The left kernel on G gives
// TᵀG from its B·d gathered rows.  The TPU kernel folded both d×d pieces
// into its one sweep, carried across a grid that ran in order; here each
// piece is a small deterministic launch over B·d rows.  Bound: the gather's
// bytes, 151 MB at R = N = 32768, d = 64, B = 16 in float32 (45 µs).
// --------------------------------------------------------------------------
template <typename T>
cudaError_t launch_grow(const void* K, const int* idx, const float* coef, const float* Cin,
                        float a, float* out, float* G32, float* TtG, float* TtC, int R, int N,
                        int B, int d, int rows, cudaStream_t stream) {
  cudaError_t e = launch_left<float>(Cin, idx, coef, TtC, R, d, B, d, stream);
  if (e != cudaSuccess) return e;
  e = launch_gather<T, float>(K, idx, coef, Cin, a, G32, out, R, N, B, d, rows, stream);
  if (e != cudaSuccess) return e;
  return launch_left<float>(G32, idx, coef, TtG, R, d, B, d, stream);
}

// --------------------------------------------------------------------------
// accum_apply_scalar — replaces AA:529 `accum_apply_scalar` (body AA:514
// `_scalar_kernel`): the seed's scalar per-column gather loop, kept as the
// naive baseline of the K·S microbenchmark (benchmarks/kernel_bench.py).
//
// out[r, j] = Σ_{i<m} coef[i, j] · K[r, idx[i, j]]   (float32 sum, out in K's type)
//
// Grid (R/bm, d/bd), as the TPU kernel's.  A thread takes one of the
// block's bm rows at a time and loops over the block's bd columns and the m
// sub-sketches in order, reading one K[r, idx[i, j]] at a time, with idx
// and coef read from global memory at every step.  Deliberately untuned: no
// shared-memory staging, no autotune, no vectorisation.  Neighbouring
// threads read one column of neighbouring rows, N elements apart, so each
// read is its own 32-byte sector, as in the gather above.  Bound on the
// H100: bytes, the R·m·d sampled entries of K and the R·d outputs.
// --------------------------------------------------------------------------
template <typename T>
__global__ void accum_apply_scalar_kernel(const T* __restrict__ K, const int* __restrict__ idx,
                                          const float* __restrict__ coef, T* __restrict__ out,
                                          int N, int m, int d, int bm, int bd) {
  const int r0 = blockIdx.x * bm, j0 = blockIdx.y * bd;
  for (int r = r0 + threadIdx.x; r < r0 + bm; r += blockDim.x) {
    const T* Kr = K + (size_t)r * N;
    for (int jj = 0; jj < bd; ++jj) {
      const int j = j0 + jj;
      float acc = 0.0f;
      for (int i = 0; i < m; ++i) {
        const int col = idx[i * d + j];
        const float v = (unsigned)col < (unsigned)N ? to_f32(Kr[col]) : __int_as_float(0x7fc00000);
        acc += coef[i * d + j] * v;
      }
      store(out + (size_t)r * d + j, acc);
    }
  }
}

template <typename T>
cudaError_t launch_scalar(const void* K, const int* idx, const float* coef, void* out, int R,
                          int N, int m, int d, int bm, int bd, cudaStream_t stream) {
  const dim3 grid(R / bm, d / bd);
  accum_apply_scalar_kernel<T><<<grid, bm < 256 ? bm : 256, 0, stream>>>(
      static_cast<const T*>(K), idx, coef, static_cast<T*>(out), N, m, d, bm, bd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_matfree_apply(const void* X, const void* L, const float* coef, float* out, int n, int p,
                        int m, int d, int jc, int gauss, float scale, float p1, float p2,
                        int rows, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_matfree<__nv_bfloat16>(X, L, coef, out, n, p, m, d, jc, gauss, scale,
                                                   p1, p2, rows, s)
                 : dispatch_matfree<float>(X, L, coef, out, n, p, m, d, jc, gauss, scale, p1, p2,
                                           rows, s);
}

int repro_accum_apply_left(const void* M, const int* idx, const float* coef, float* out, int N,
                           int c, int m, int d, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_left<__nv_bfloat16>(M, idx, coef, out, N, c, m, d, s)
                 : launch_left<float>(M, idx, coef, out, N, c, m, d, s);
}

int repro_accum_sketch_both(const void* K, const int* idx, const float* coef, float* C32,
                            void* Cout, float* W, int R, int N, int m, int d, int rows,
                            int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_both<__nv_bfloat16>(K, idx, coef, C32, Cout, W, R, N, m, d, rows, s)
                 : launch_both<float>(K, idx, coef, C32, Cout, W, R, N, m, d, rows, s);
}

int repro_accum_apply(const void* K, const int* idx, const float* coef, void* out, int R, int N,
                      int m, int d, int rows, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_apply<__nv_bfloat16>(K, idx, coef, out, R, N, m, d, rows, s)
                 : launch_apply<float>(K, idx, coef, out, R, N, m, d, rows, s);
}

int repro_accum_step_slab(const void* K, const int* idx, const float* coef, const float* Cin,
                          float a, float* out, int R, int N, int d, int rows, int is_bf16,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_step<__nv_bfloat16>(K, idx, coef, Cin, a, out, R, N, d, rows, s)
                 : launch_step<float>(K, idx, coef, Cin, a, out, R, N, d, rows, s);
}

int repro_accum_grow_slabs(const void* K, const int* idx, const float* coef, const float* Cin,
                           float a, float* out, float* G32, float* TtG, float* TtC, int R, int N,
                           int B, int d, int rows, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_grow<__nv_bfloat16>(K, idx, coef, Cin, a, out, G32, TtG, TtC, R, N, B,
                                              d, rows, s)
                 : launch_grow<float>(K, idx, coef, Cin, a, out, G32, TtG, TtC, R, N, B, d, rows,
                                      s);
}

// bm divides R and bd divides d (kernel.py checks both, as the reference
// asserts them).
int repro_accum_apply_scalar(const void* K, const int* idx, const float* coef, void* out, int R,
                             int N, int m, int d, int bm, int bd, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_scalar<__nv_bfloat16>(K, idx, coef, out, R, N, m, d, bm, bd, s)
                 : launch_scalar<float>(K, idx, coef, out, R, N, m, d, bm, bd, s);
}

}  // extern "C"
