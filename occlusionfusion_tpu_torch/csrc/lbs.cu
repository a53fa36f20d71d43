// Linear-blend-skinning voxel warp (K2).
//
// Replaces the TPU kernel occlusionfusion_tpu/ops/lbs.py::lbs_warp_pallas
// (_lbs_kernel): y = (sum_k w_k R_k) x + sum_k w_k t'_k with origin-form
// translations t' = t + g - R g; points without a reachable anchor pass
// through unchanged.
//
// Design: one thread per voxel, gathering its K anchor transforms
// (12 floats each, origin form, packed [N, 12] by the wrapper) straight
// from device memory in f32. The TPU kernel's one-hot bf16 hi/lo matmul
// existed only to use the MXU and is dropped. At 2M voxels x 512 nodes
// the warp is bound by device memory: 57 bytes per voxel in and out
// (120 MB, 36 us at 3.35 TB/s); the [N, 12] table (24 KB) stays in L1/L2.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int K = 4;  // anchors per voxel: the skinning's GRAPH_K

__global__ void lbs_kernel(const float* __restrict__ pts,
                           const int32_t* __restrict__ anchors,
                           const float* __restrict__ weights,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ T, int P, int N,
                           float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float x = pts[3 * p + 0];
  const float y = pts[3 * p + 1];
  const float z = pts[3 * p + 2];
  if (!valid[p]) {
    out[3 * p + 0] = x;
    out[3 * p + 1] = y;
    out[3 * p + 2] = z;
    return;
  }
  float B[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) B[c] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int a = anchors[p * K + k];
    a = min(max(a, 0), N - 1);
    const float w = weights[p * K + k];
    const float* Tk = T + 12 * (int64_t)a;
#pragma unroll
    for (int c = 0; c < 12; ++c) B[c] += w * __ldg(Tk + c);
  }
  out[3 * p + 0] = B[0] * x + B[1] * y + B[2] * z + B[9];
  out[3 * p + 1] = B[3] * x + B[4] * y + B[5] * z + B[10];
  out[3 * p + 2] = B[6] * x + B[7] * y + B[8] * z + B[11];
}

}  // namespace

extern "C" int of_lbs_warp(const void* pts, const void* anchors,
                           const void* weights, const void* valid,
                           const void* T, int P, int k, int N, void* out,
                           void* stream) {
  if (k != K || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0) return 0;
  const int blocks = (P + kThreads - 1) / kThreads;
  lbs_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int32_t*>(anchors),
      static_cast<const float*>(weights), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(T), P, N, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
