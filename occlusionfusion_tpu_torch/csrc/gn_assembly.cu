// Gauss-Newton point-term block assembly (K3).
//
// Replaces the TPU kernel
// occlusionfusion_tpu/ops/gn_assembly.py::point_term_blocks_pallas
// (_assembly_kernel). It follows the semantics of the XLA "blocks" path,
// solvers/gauss_newton_dense.py::_assemble_blocks, which the TPU kernel
// does not for fractional point weights: the warp blends with the raw
// skinning weights w_k, the jacobian uses the gated weights w_k * pv, and
// the residual carries pv once. Per point p:
//   local_k = R_k (x - g_k)
//   J_k     = sw * [-hat(local_k) * w_k pv | w_k pv I]          [3 x 6]
//   r       = sw * pv * (sum_k w_k (local_k + g_k + t_k) - y)    [3]
//   blk[p, k*4+l] = J_k^T J_l [6 x 6],  b[p, k] = J_k^T r,  rsq[p] = r.r
//
// Design: one thread per point; the node rows (R 9 | g 3 | t 3) of its
// four anchors are gathered from device memory in f32 (no one-hot
// matmul: that existed only to feed the TPU's MXU). The output is
// 601 floats per point (2.4 KB), so at P = 8192 the kernel is bound by
// writing its 19.7 MB of blocks (6 us at 3.35 TB/s), not by its 3 kflop
// per point.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kK = 4;

__global__ void point_term_kernel(
    const float* __restrict__ pts, const float* __restrict__ tgt,
    const float* __restrict__ pv, const int32_t* __restrict__ anchors,
    const float* __restrict__ weights, const float* __restrict__ nodes,
    const float* __restrict__ R, const float* __restrict__ t, float sw,
    int P, int N, float* __restrict__ blk, float* __restrict__ bvec,
    float* __restrict__ rsq) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float x[3] = {pts[3 * p], pts[3 * p + 1], pts[3 * p + 2]};
  const float pvp = pv[p];
  float warped[3] = {0.f, 0.f, 0.f};
  float J[kK][3][6];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    int a = anchors[p * kK + k];
    a = min(max(a, 0), N - 1);
    const float w = weights[p * kK + k];
    const float* Rk = R + 9 * (int64_t)a;
    const float g[3] = {__ldg(nodes + 3 * a), __ldg(nodes + 3 * a + 1),
                        __ldg(nodes + 3 * a + 2)};
    const float tk[3] = {__ldg(t + 3 * a), __ldg(t + 3 * a + 1),
                         __ldg(t + 3 * a + 2)};
    const float d[3] = {x[0] - g[0], x[1] - g[1], x[2] - g[2]};
    float l[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      l[i] = __ldg(Rk + 3 * i) * d[0] + __ldg(Rk + 3 * i + 1) * d[1] +
             __ldg(Rk + 3 * i + 2) * d[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) warped[i] += w * (l[i] + g[i] + tk[i]);
    const float wg = w * pvp;
    // -hat(l) = [[0, lz, -ly], [-lz, 0, lx], [ly, -lx, 0]]
    const float nh[3][3] = {{0.f, l[2], -l[1]},
                            {-l[2], 0.f, l[0]},
                            {l[1], -l[0], 0.f}};
#pragma unroll
    for (int a3 = 0; a3 < 3; ++a3) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        J[k][a3][i] = sw * (nh[a3][i] * wg);
        J[k][a3][3 + i] = (a3 == i) ? sw * wg : 0.f;
      }
    }
  }
  const float spv = sw * pvp;
  float r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = spv * (warped[i] - tgt[3 * p + i]);

  float* out = blk + p * (kK * kK * 36);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
#pragma unroll
    for (int l = 0; l < kK; ++l) {
      float* o = out + (k * kK + l) * 36;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          o[i * 6 + j] = J[k][0][i] * J[l][0][j] + J[k][1][i] * J[l][1][j] +
                         J[k][2][i] * J[l][2][j];
        }
      }
    }
  }
  float* bo = bvec + p * (kK * 6);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      bo[k * 6 + i] =
          J[k][0][i] * r[0] + J[k][1][i] * r[1] + J[k][2][i] * r[2];
    }
  }
  rsq[p] = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
}

}  // namespace

extern "C" int of_point_term_blocks(const void* pts, const void* tgt,
                                    const void* pv, const void* anchors,
                                    const void* weights, const void* nodes,
                                    const void* R, const void* t, float sw,
                                    int P, int N, void* blk_out,
                                    void* b_out, void* rsq_out,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return 0;
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kThreads - 1) / kThreads;
  point_term_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(pts), static_cast<const float*>(tgt),
      static_cast<const float*>(pv), static_cast<const int32_t*>(anchors),
      static_cast<const float*>(weights), static_cast<const float*>(nodes),
      static_cast<const float*>(R), static_cast<const float*>(t), sw, P, N,
      static_cast<float*>(blk_out), static_cast<float*>(b_out),
      static_cast<float*>(rsq_out));
  return static_cast<int>(cudaGetLastError());
}
