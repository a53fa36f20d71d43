// Gauss-Newton ARAP edge-term block assembly (K4).
//
// Replaces the TPU kernel
// occlusionfusion_tpu/ops/gn_assembly.py::arap_term_blocks_pallas
// (_arap_kernel). Per node i and edge slot k (neighbour j, weight wa):
//   rot  = R_i (g_j - g_i)
//   r    = wa * (rot + g_i + t_i - g_j - t_j)                   [3]
//   J_i  = wa * [-hat(rot) | I],  J_j = wa * [0 | -I]          [3 x 6]
//   ii[i]     = sum_k J_i^T J_i     ij[i, k] = J_i^T J_j
//   ji[i, k]  = ij[i, k]^T          jj[i, k] = J_j^T J_j
//   b_i[i]    = sum_k J_i^T r       b_j[i, k] = J_j^T r
//   rsq[i]    = sum_k r . r
// Edges arrive clamped to >= 0; invalid edges carry wa = 0, so all their
// outputs are zero.
//
// Design: one thread per node, looping over its edges with ii, b_i and
// rsq in registers. The neighbour rows g_j, t_j are gathered straight
// from device memory in f32: the TPU kernel's one-hot bf16 hi/lo matmul
// (~2^-17 relative) existed only to feed the MXU and is dropped. At
// 512 nodes x 8 edges the kernel writes 2.0 MB (0.6 us at 3.35 TB/s)
// for ~2 MFLOP, so it is bound by bytes, and in practice by its launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 64;

__global__ void arap_term_kernel(
    const float* __restrict__ nodes, const float* __restrict__ R,
    const float* __restrict__ t, const int32_t* __restrict__ edges,
    const float* __restrict__ wa, int N, int E, float* __restrict__ ii,
    float* __restrict__ ij, float* __restrict__ ji, float* __restrict__ jj,
    float* __restrict__ bi, float* __restrict__ bj,
    float* __restrict__ rsq) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float Ri[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) Ri[c] = R[9 * n + c];
  const float gi[3] = {nodes[3 * n], nodes[3 * n + 1], nodes[3 * n + 2]};
  const float ti[3] = {t[3 * n], t[3 * n + 1], t[3 * n + 2]};
  float acc_ii[6][6];
  float acc_bi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc_bi[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc_ii[i][j] = 0.f;
  }
  float sq = 0.f;
  for (int k = 0; k < E; ++k) {
    const int64_t ek = n * E + k;
    const int j = min(max(edges[ek], 0), N - 1);
    const float w = wa[ek];
    const float gj[3] = {__ldg(nodes + 3 * j), __ldg(nodes + 3 * j + 1),
                         __ldg(nodes + 3 * j + 2)};
    const float tj[3] = {__ldg(t + 3 * j), __ldg(t + 3 * j + 1),
                         __ldg(t + 3 * j + 2)};
    const float d[3] = {gj[0] - gi[0], gj[1] - gi[1], gj[2] - gi[2]};
    float rot[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rot[a] = Ri[3 * a] * d[0] + Ri[3 * a + 1] * d[1] + Ri[3 * a + 2] * d[2];
    float r[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      r[a] = w * (rot[a] + gi[a] + ti[a] - gj[a] - tj[a]);
    // J_i rows a, columns i: -hat(rot) = [[0, rz, -ry], [-rz, 0, rx],
    // [ry, -rx, 0]] scaled by wa, then wa on the translation diagonal
    const float nh[3][3] = {{0.f, rot[2], -rot[1]},
                            {-rot[2], 0.f, rot[0]},
                            {rot[1], -rot[0], 0.f}};
    float Ji[3][6];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Ji[a][c] = nh[a][c] * w;
        Ji[a][3 + c] = (a == c) ? w : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int c = 0; c < 6; ++c)
        acc_ii[i][c] += Ji[0][i] * Ji[0][c] + Ji[1][i] * Ji[1][c] +
                        Ji[2][i] * Ji[2][c];
      acc_bi[i] += Ji[0][i] * r[0] + Ji[1][i] * r[1] + Ji[2][i] * r[2];
    }
    // J_j = wa [0 | -I]: ij[i][c] = -wa J_i[c - 3][i] for c >= 3, else 0;
    // jj = wa^2 on the translation diagonal; b_j = -wa r on translation
    float* oij = ij + ek * 36;
    float* oji = ji + ek * 36;
    float* ojj = jj + ek * 36;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float v = (c >= 3) ? -(w * Ji[c - 3][i]) : 0.f;
        oij[i * 6 + c] = v;
        oji[c * 6 + i] = v;
        ojj[i * 6 + c] = (i == c && i >= 3) ? w * w : 0.f;
      }
      bj[ek * 6 + i] = (i >= 3) ? -(w * r[i - 3]) : 0.f;
    }
    sq += r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int c = 0; c < 6; ++c) ii[n * 36 + i * 6 + c] = acc_ii[i][c];
    bi[n * 6 + i] = acc_bi[i];
  }
  rsq[n] = sq;
}

}  // namespace

extern "C" int of_arap_term_blocks(const void* nodes, const void* R,
                                   const void* t, const void* edges,
                                   const void* wa, int N, int E,
                                   void* ii_out, void* ij_out, void* ji_out,
                                   void* jj_out, void* bi_out, void* bj_out,
                                   void* rsq_out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return 0;
  if (E < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (N + kThreads - 1) / kThreads;
  arap_term_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(nodes), static_cast<const float*>(R),
      static_cast<const float*>(t), static_cast<const int32_t*>(edges),
      static_cast<const float*>(wa), N, E, static_cast<float*>(ii_out),
      static_cast<float*>(ij_out), static_cast<float*>(ji_out),
      static_cast<float*>(jj_out), static_cast<float*>(bi_out),
      static_cast<float*>(bj_out), static_cast<float*>(rsq_out));
  return static_cast<int>(cudaGetLastError());
}
