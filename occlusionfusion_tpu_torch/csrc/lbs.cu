// Linear-blend-skinning voxel warp (K2).
//
// Replaces the TPU kernel occlusionfusion_tpu/ops/lbs.py::lbs_warp_pallas
// (_lbs_kernel): y = (sum_k w_k R_k) x + sum_k w_k t'_k with origin-form
// translations t' = t + g - R g; points without a reachable anchor pass
// through unchanged.
//
// Bound: device memory. Counting what the inputs need: 25 bytes per
// voxel (xyz in and out, the valid byte), 32 more (4 anchors, 4 weights)
// per valid voxel, and the node table once. At 2M voxels that is
// 0.017 ms at 3.35 TB/s with 5% of them valid (the main path) and
// 0.032 ms with 80% valid. The TPU kernel's one-hot bf16 hi/lo matmul
// existed only to use the MXU and is dropped.
//
// Design:
//  * Persistent blocks, as many as fit on the card at once. Each forms
//    the origin-form table [N, 12] (row-major R, then t' = (t + g) - R g)
//    once in shared memory from the node positions, rotations and
//    translations, so no packing pass runs before the kernel and the
//    table's rows are gathered from shared memory as three float4 each.
//  * Each warp then walks chunks of 32 voxels (grid-stride): the chunk's
//    xyz (96 floats) is read and written by the whole warp as coalesced
//    scalars through a per-warp staging buffer; a valid voxel reads its
//    anchors as one int4 and its weights as one float4, an invalid one
//    reads neither and passes through bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int K = 4;  // anchors per voxel: the skinning's GRAPH_K

__global__ void __launch_bounds__(kThreads)
lbs_kernel(const float* __restrict__ pts, const int4* __restrict__ anchors,
           const float4* __restrict__ weights,
           const uint8_t* __restrict__ valid,
           const float* __restrict__ nodes, const float* __restrict__ rot,
           const float* __restrict__ trans, int P, int N,
           float* __restrict__ out) {
  extern __shared__ float4 table[];  // [N][3]: R0-3, R4-7, (R8, t')
  __shared__ float stage[kWarps][96];

  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float* R = rot + 9 * (int64_t)n;
    const float g[3] = {nodes[3 * n + 0], nodes[3 * n + 1],
                        nodes[3 * n + 2]};
    float tp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float Rg =
          R[3 * i + 0] * g[0] + R[3 * i + 1] * g[1] + R[3 * i + 2] * g[2];
      tp[i] = (trans[3 * n + i] + g[i]) - Rg;
    }
    table[3 * n + 0] = make_float4(R[0], R[1], R[2], R[3]);
    table[3 * n + 1] = make_float4(R[4], R[5], R[6], R[7]);
    table[3 * n + 2] = make_float4(R[8], tp[0], tp[1], tp[2]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* st = stage[warp];
  const int64_t n_chunks = ((int64_t)P + 31) / 32;
  for (int64_t c = (int64_t)blockIdx.x * kWarps + warp; c < n_chunks;
       c += (int64_t)gridDim.x * kWarps) {
    const int64_t base = c * 32;
    const int64_t rest = (int64_t)P - base;
    const int here = rest < 32 ? static_cast<int>(rest) : 32;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int e = lane + 32 * s;
      if (e < 3 * here) st[e] = pts[3 * base + e];
    }
    __syncwarp();
    const int64_t p = base + lane;
    if (lane < here && valid[p]) {
      const float x = st[3 * lane + 0], y = st[3 * lane + 1],
                  z = st[3 * lane + 2];
      const int4 a4 = anchors[p];
      const float4 w4 = weights[p];
      const int a[K] = {a4.x, a4.y, a4.z, a4.w};
      const float w[K] = {w4.x, w4.y, w4.z, w4.w};
      float B[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) B[i] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int row = 3 * min(max(a[k], 0), N - 1);
        const float4 r0 = table[row], r1 = table[row + 1],
                     r2 = table[row + 2];
        const float T[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                             r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
#pragma unroll
        for (int i = 0; i < 12; ++i) B[i] += w[k] * T[i];
      }
      st[3 * lane + 0] = B[0] * x + B[1] * y + B[2] * z + B[9];
      st[3 * lane + 1] = B[3] * x + B[4] * y + B[5] * z + B[10];
      st[3 * lane + 2] = B[6] * x + B[7] * y + B[8] * z + B[11];
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int e = lane + 32 * s;
      if (e < 3 * here) out[3 * base + e] = st[e];
    }
    __syncwarp();
  }
}

}  // namespace

// N may be at most what fits in shared memory beside the staging
// buffers (ops/lbs.py::MAX_NODES holds the H100's figure). anchors and
// weights are read as int4 / float4: their base addresses must be 16-byte
// aligned (ops/lbs.py::lbs_warp_cuda checks it).
extern "C" int of_lbs_warp(const void* pts, const void* anchors,
                           const void* weights, const void* valid,
                           const void* nodes, const void* rot,
                           const void* trans, int P, int k, int N, void* out,
                           void* stream) {
  if (k != K || N <= 0 || reinterpret_cast<uintptr_t>(anchors) % 16 ||
      reinterpret_cast<uintptr_t>(weights) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0) return 0;
  const size_t smem = (size_t)N * 3 * sizeof(float4);
  cudaFuncAttributes fa;
  cudaError_t e;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (e = cudaFuncGetAttributes(&fa, lbs_kernel)) != cudaSuccess)
    return static_cast<int>(e);
  if (smem + fa.sharedSizeBytes > (size_t)optin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lbs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lbs_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  const int64_t needed = ((int64_t)P + kThreads - 1) / kThreads;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  lbs_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int4*>(anchors),
      static_cast<const float4*>(weights), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(nodes), static_cast<const float*>(rot),
      static_cast<const float*>(trans), P, N, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
