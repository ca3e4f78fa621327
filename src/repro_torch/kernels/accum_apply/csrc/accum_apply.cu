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
// measured autotune cache (autotune.py).  A block's threads, shared memory
// and registers do not depend on it, and each output element keeps its one
// owner and its order of summation, so every row count gives the same bits.
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

enum KernelKind { GAUSSIAN = 0, LAPLACIAN = 1, MATERN05 = 2, MATERN15 = 3, MATERN25 = 4 };

// The closed forms of core/kernels_math.py (and AA:426 `_kernel_eval`), on
// the clamped expanded squared distance.  gdenom = 2·bw² rounded to float32
// on the host, as the reference's weakly typed constant is.
__device__ __forceinline__ float kernel_value(float d2, int kind, float bw, float gdenom) {
  if (kind == GAUSSIAN) return expf(-d2 / gdenom);
  float r = sqrtf(d2 + 1e-30f);
  if (kind == LAPLACIAN) return expf(-r / bw);
  r = r / bw;
  if (kind == MATERN05) return expf(-r);
  if (kind == MATERN15) {
    const float c = 1.7320508075688772f;
    return (1.0f + c * r) * expf(-c * r);
  }
  const float c = 2.23606797749979f;
  return (1.0f + c * r + 5.0f * r * r / 3.0f) * expf(-c * r);
}

// --------------------------------------------------------------------------
// matfree_apply — replaces AA:474 `matfree_apply`.
//
// out[r, j] = Σ_{i<m} coef[i, j] · k(X[r], L[i·d + j]),   out (n, d) float32
//
// Bound on the H100: bytes.  The inputs are X (n·p) and the m·d landmark
// rows; the output is n·d float32, which dominates (512 MiB at n = 2^21,
// d = 64).  The m·d·n kernel evaluations (about 13 float32 operations each
// at p = 3) take less time than writing C at 3.35 TB/s.
//
// Design: a block of 32 × 8 threads takes `rows` rows of X (64 unless the
// autotune cache chose otherwise) and a group of `jc`
// output columns (grid.y; all d columns when the group's landmarks fit 48
// KB).  It stages the group's m·jc landmark rows transposed, (p, m·jc), with
// their squared norms and coefficients, in shared memory.  A warp takes RB
// rows at a time (4 when p ≤ 4) with its lanes along the output columns: the
// lanes read neighbouring landmarks (no bank conflicts) and use each for RB
// rows held in registers, all lanes read the same rows of X (broadcasts),
// and they write neighbouring elements of C, so every store is coalesced.  The Cmat of the TPU kernel
// (ops.expand_coef) is never built: the sum over i < m is the contraction.
// --------------------------------------------------------------------------
template <typename T, int P, int RB>
__global__ void matfree_apply_kernel(const T* __restrict__ X, const T* __restrict__ L,
                                     const float* __restrict__ coef, float* __restrict__ out,
                                     int n, int p, int m, int d, int jc, int kind, float bw,
                                     float gdenom, int rows) {
  constexpr int PR = P > 0 ? P : 1;   // x held in registers when P > 0
  extern __shared__ float smem[];
  const int j0 = blockIdx.y * jc;
  const int jw = min(jc, d - j0);
  const int nl = m * jw;        // landmark l = i·jw + jj  ↔  row i·d + j0 + jj of L
  float* sLT = smem;            // (p, nl), transposed
  float* sL2 = sLT + nl * p;    // (nl,)
  float* sC = sL2 + nl;         // (nl,)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int t = tid; t < nl * p; t += nthreads) {
    const int l = t / p, k = t - l * p;
    const int i = l / jw, jj = l - i * jw;
    sLT[k * nl + l] = to_f32(L[(size_t)(i * d + j0 + jj) * p + k]);
  }
  for (int l = tid; l < nl; l += nthreads) {
    const int i = l / jw, jj = l - i * jw;
    sC[l] = coef[i * d + j0 + jj];
  }
  __syncthreads();
  for (int l = tid; l < nl; l += nthreads) {
    float s = 0.0f;
    for (int k = 0; k < p; ++k) s += sLT[k * nl + l] * sLT[k * nl + l];
    sL2[l] = s;
  }
  __syncthreads();

  // RB rows at a time per warp: each landmark read from shared memory
  // serves RB kernel evaluations
  const int r_end = (int)min((long long)n, (long long)(blockIdx.x + 1) * rows);
  for (int rb = blockIdx.x * rows + threadIdx.y * RB; rb < r_end;
       rb += blockDim.y * RB) {
    float xreg[RB][PR];
    float x2[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const T* xr = X + (size_t)min(rb + q, r_end - 1) * p;
      x2[q] = 0.0f;
      if (P > 0) {
#pragma unroll
        for (int k = 0; k < PR; ++k) {
          const float v = k < p ? to_f32(xr[k]) : 0.0f;
          xreg[q][k] = v;
          x2[q] += v * v;
        }
      } else {
        for (int k = 0; k < p; ++k) {
          const float v = to_f32(xr[k]);
          x2[q] += v * v;
        }
      }
    }
    for (int jj = threadIdx.x; jj < jw; jj += blockDim.x) {
      float acc[RB];
#pragma unroll
      for (int q = 0; q < RB; ++q) acc[q] = 0.0f;
      for (int i = 0; i < m; ++i) {
        const int l = i * jw + jj;
        const float l2 = sL2[l], c = sC[l];
        float lk[PR];
        if (P > 0) {
#pragma unroll
          for (int k = 0; k < PR; ++k) lk[k] = k < p ? sLT[k * nl + l] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          float dot = 0.0f;
          if (P > 0) {
#pragma unroll
            for (int k = 0; k < PR; ++k)
              if (k < p) dot += xreg[q][k] * lk[k];
          } else {
            const T* xr = X + (size_t)(rb + q) * p;
            for (int k = 0; k < p; ++k) dot += to_f32(xr[k]) * sLT[k * nl + l];
          }
          const float d2 = fmaxf(x2[q] + l2 - 2.0f * dot, 0.0f);
          acc[q] += c * kernel_value(d2, kind, bw, gdenom);
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q)
        if (rb + q < r_end) out[(size_t)(rb + q) * d + j0 + jj] = acc[q];
    }
  }
}

template <typename T, int P>
cudaError_t launch_matfree(const void* X, const void* L, const float* coef, float* out, int n,
                           int p, int m, int d, int jc, int kind, float bw, float gdenom,
                           int rows, cudaStream_t stream) {
  const size_t smem = (size_t)m * jc * (p + 2) * sizeof(float);
  // four rows per warp step where x is held in registers
  auto kern = matfree_apply_kernel<T, P, (P > 0 ? 4 : 1)>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + rows - 1) / rows, (d + jc - 1) / jc);
  kern<<<grid, dim3(32, 8), smem, stream>>>(static_cast<const T*>(X), static_cast<const T*>(L),
                                            coef, out, n, p, m, d, jc, kind, bw, gdenom, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_matfree(const void* X, const void* L, const float* coef, float* out, int n,
                             int p, int m, int d, int jc, int kind, float bw, float gdenom,
                             int rows, cudaStream_t s) {
  // p ≤ 4 (the measured main path has p = 3) keeps x in registers; any
  // other p reads x from global memory
  if (p <= 4)
    return launch_matfree<T, 4>(X, L, coef, out, n, p, m, d, jc, kind, bw, gdenom, rows, s);
  return launch_matfree<T, 0>(X, L, coef, out, n, p, m, d, jc, kind, bw, gdenom, rows, s);
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
// Bound on the H100: bytes.  It needs the R·m·d entries of K at the sampled
// columns and writes R·d outputs.  The gathered entries lie in separate
// 32-byte sectors, so the card moves up to 8 times the needed bytes of K
// (16 times in bfloat16).
//
// Design: a block takes `rows` rows (64 unless the autotune cache chose
// otherwise) and stages idx/coef in shared memory (where they fit 48 KB); a
// warp takes one row at a time with its lanes along j, so
// the reads of Cin and the writes are coalesced, and each lane sums its m
// terms in order.  One pass, no reduction across threads or blocks.
// --------------------------------------------------------------------------
template <typename T, typename TO>
__global__ void sketch_gather_kernel(const T* __restrict__ K, const int* __restrict__ idx,
                                     const float* __restrict__ coef, const float* Cin, float a,
                                     float* __restrict__ C32, TO* Cout, int R, int N, int m,
                                     int d, int staged, int rows) {
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
  const size_t smem = (size_t)m * d * (sizeof(int) + sizeof(float));
  const int staged = smem <= 48 * 1024;
  const dim3 grid((R + rows - 1) / rows);
  sketch_gather_kernel<T, TO><<<grid, dim3(32, 8), staged ? smem : 0, stream>>>(
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
                        int m, int d, int jc, int kind, float bw, float gdenom, int rows,
                        int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_matfree<__nv_bfloat16>(X, L, coef, out, n, p, m, d, jc, kind, bw,
                                                   gdenom, rows, s)
                 : dispatch_matfree<float>(X, L, coef, out, n, p, m, d, jc, kind, bw, gdenom,
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
