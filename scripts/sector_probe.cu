// The card's rate for reads of random 32-byte sectors, the floor of the
// column gather in src/repro_torch/kernels/accum_apply/csrc/accum_apply.cu.
//
// One warp takes a row of a row-major (R, N) float32 matrix at a time, its
// lanes along a list of S sampled columns (the same list for every row, as a
// sketch's columns are).  BYTES = 4: each lane reads the one element
// K[r, cols[s]], as the gather does; 32: the whole 32-byte sector that holds
// it (two 16-byte loads); 64: the whole 64-byte segment (four).  The order of
// `cols` is the caller's (as drawn, or sorted ascending).  The loads are
// summed, and the sum is stored only if it takes an impossible value, so no
// load is dropped and nothing is written.
//
// Built by chip_smoke.py (``sector_rates``) with the port's nvcc flags; plain
// C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

template <int BYTES>
__global__ void __launch_bounds__(256) sector_probe_kernel(const float* __restrict__ K,
                                                           const int* __restrict__ cols, int R,
                                                           int N, int S, float* sink) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  float acc = 0.0f;
  for (int r = warp; r < R; r += nwarps) {
    const float* Kr = K + (size_t)r * N;
#pragma unroll 8
    for (int s = lane; s < S; s += 32) {
      const int c = cols[s];
      if (BYTES == 4) {
        acc += Kr[c];
      } else {
        const float4* q = reinterpret_cast<const float4*>(Kr + (c & ~(BYTES / 4 - 1)));
#pragma unroll
        for (int u = 0; u < BYTES / 16; ++u) {
          const float4 v = q[u];
          acc += (v.x + v.y) + (v.z + v.w);
        }
      }
    }
  }
  if (acc == -1.2345e-38f) sink[0] = acc;
}

}  // namespace

extern "C" int repro_sector_probe(const float* K, const int* cols, int R, int N, int S,
                                  int bytes, int blocks, float* sink, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bytes == 4)
    sector_probe_kernel<4><<<blocks, 256, 0, s>>>(K, cols, R, N, S, sink);
  else if (bytes == 32)
    sector_probe_kernel<32><<<blocks, 256, 0, s>>>(K, cols, R, N, S, sink);
  else
    sector_probe_kernel<64><<<blocks, 256, 0, s>>>(K, cols, R, N, S, sink);
  return cudaGetLastError();
}
