// Device helpers of the kernels that add the Gauss-Newton terms straight
// into the dense normal equations (gn_assembly.cu, arap_term.cu).
//
// M is [6N, 6N] f32 row-major: the 6x6 block of node pair (a, c) starts
// at row 6a, column 6c, as the JAX package's
// M_blocks.reshape(n, n, 6, 6).transpose(0, 2, 1, 3) lays it out.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

// p[0] += x, p[1] += y as one 8-byte vector atomic (sm_90, global memory
// only); p must be 8-byte aligned. The result is unused, so it compiles
// to a fire-and-forget reduction.
__device__ __forceinline__ void add2(float* p, float x, float y) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// hat(v)[i][j] of hat(v) = [[0, -v2, v1], [v2, 0, -v0], [-v1, v0, 0]]
__device__ __forceinline__ float hat_entry(const float* v, int i, int j) {
  if (j == i) return 0.f;
  return (j == (i + 1) % 3) ? -v[(i + 2) % 3] : v[(i + 1) % 3];
}

// Row `row` of the 6x6 block of node pair (a, c) in M.
__device__ __forceinline__ float* block_row(float* M, int64_t ld, int a,
                                            int c, int row) {
  return M + (6 * (int64_t)a + row) * ld + 6 * (int64_t)c;
}
