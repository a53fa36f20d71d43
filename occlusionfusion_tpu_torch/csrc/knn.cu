// Brute-force k-nearest-neighbour search (K1).
//
// Replaces the TPU kernel occlusionfusion_tpu/ops/knn.py::knn_pallas
// (_knn_kernel): d2 = |q|^2 - 2 q.r + |r|^2 + bias (bias 1e30 on invalid
// refs), k rounds of argmin, d2 clamped >= 0.
//
// Design: one thread per query. The block streams the N refs through
// shared memory in tiles of kTile (x, y, z, |r|^2) and each thread
// keeps a sorted k-entry list in registers. The distance is rounded step
// by step as ops/knn.py documents (the JAX package's XLA CPU order, with
// explicit fmaf and _rn intrinsics so nvcc contracts nothing else), and
// so it matches the plain PyTorch twin knn_torch. On the H100 the search is bound by its f32 operations
// (P * N * 9 flops; 2M voxels x 512 nodes = 9.7 GFLOP at 67 TFLOP/s):
// the tile in shared memory keeps the refs off device memory.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int K = 4;  // anchors per query: the skinning's GRAPH_K

__global__ void knn_kernel(const float* __restrict__ q,
                           const float* __restrict__ r,
                           const float* __restrict__ rsq,
                           const float* __restrict__ bias, int P, int N,
                           float* __restrict__ d2_out,
                           int32_t* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = p < P;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * p + 0];
    qy = q[3 * p + 1];
    qz = q[3 * p + 2];
  }
  // |q|^2 = fma(qz, qz, fma(qy, qy, qx*qx))
  const float qsq = fmaf(qz, qz, fmaf(qy, qy, __fmul_rn(qx, qx)));
  float best_d[K];
  int best_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_d[j] = INFINITY;
    best_i[j] = 0;
  }
  for (int base = 0; base < N; base += kTile) {
    const int n_tile = min(kTile, N - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int n = base + i;
      tile[i] = make_float4(r[3 * n + 0], r[3 * n + 1], r[3 * n + 2],
                            rsq[n]);
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < n_tile; ++i) {
      const float4 rr = tile[i];
      const float dot = fmaf(qz, rr.z, fmaf(qy, rr.y, __fmul_rn(qx, rr.x)));
      float d = __fadd_rn(__fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, dot)),
                                    rr.w),
                          __ldg(bias + base + i));
      if (d < best_d[K - 1]) {
        // insertion into the sorted list; equal distances keep the
        // earlier ref first
        int j = K - 1;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (j == s && best_d[s - 1] > d) {
            best_d[s] = best_d[s - 1];
            best_i[s] = best_i[s - 1];
            j = s - 1;
          }
        }
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (s == j) {
            best_d[s] = d;
            best_i[s] = base + i;
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d2_out[(int64_t)p * K + j] = fmaxf(best_d[j], 0.f);
      idx_out[(int64_t)p * K + j] = best_i[j];
    }
  }
}

}  // namespace

extern "C" int of_knn(const void* q, const void* r, const void* rsq,
                      const void* bias, int P, int N, int k, void* d2_out,
                      void* idx_out, void* stream) {
  if (k != K || N < K) return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0) return 0;
  const int blocks = (P + kThreads - 1) / kThreads;
  knn_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<const float*>(rsq), static_cast<const float*>(bias), P, N,
      static_cast<float*>(d2_out), static_cast<int32_t*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}
