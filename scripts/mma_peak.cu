// Peak rate of the warp-level tensor-core instruction (mma.sync) on the
// card, for scripts/bench_landmark.py --mma-peak: every warp issues `iters`
// rounds of eight independent products into eight accumulators, so nothing
// but the tensor pipe's issue rate limits it.
//
//   kind 0: m16n8k8 TF32 (the landmark sweep's instruction), 2·16·8·8 flops
//   kind 1: m16n8k16 bfloat16, 2·16·8·16 flops
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int KIND>
__global__ void mma_loop(float* out, int iters) {
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + 1e-3f * (threadIdx.x + i));
  b[0] = a[1];
  b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// *ms = device milliseconds of one launch of `blocks` × `threads` threads
// (after one warm-up launch); out holds blocks × threads floats.
int repro_mma_peak(int kind, int blocks, int threads, int iters, float* out, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (kind == 0)
      mma_loop<0><<<blocks, threads>>>(out, iters);
    else
      mma_loop<1><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
  }
  cudaError_t e = cudaEventSynchronize(e1);
  if (e == cudaSuccess) e = cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

}  // extern "C"
