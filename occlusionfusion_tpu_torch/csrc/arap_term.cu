// Gauss-Newton ARAP edge term and motion prior, accumulated in place
// (K4').
//
// Replaces the TPU kernel
// occlusionfusion_tpu/ops/gn_assembly.py::arap_term_blocks_pallas
// (_arap_kernel) together with the caller's scatter of its blocks and
// the motion-prior ops: it adds both terms straight into the dense
// normal equations M [6N, 6N], b [6N] and sq, as the JAX package's
// solvers/gauss_newton_dense.py::_assemble_blocks(assembly="blocks")
// does. Per node i and edge slot k (neighbour j, weight wa):
//   rho = R_i (g_j - g_i)
//   r   = wa (rho + g_i + t_i - g_j - t_j)                       [3]
//   J_i = wa [-hat(rho) | I],  J_j = wa [0 | -I]                 [3 x 6]
//   M[i, i] += J_i^T J_i = wa^2 [[|rho|^2 I - rho rho^T, hat(rho)],
//                                [-hat(rho),             I       ]]
//   M[i, j] += J_i^T J_j = wa^2 [[0, -hat(rho)], [0, -I]]
//   M[j, i] += (J_i^T J_j)^T,   M[j, j] += wa^2 [[0, 0], [0, I]]
//   b[i] += J_i^T r = wa [rho x r; r],   b[j] += [0; -wa r],   sq += r.r
// and per node the motion prior r_m = wm (g_i + t_i - m_i):
//   M[i, i] += wm^2 on the translation diagonal,  b[i] += [0; wm r_m],
//   sq += r_m.r_m.
// Edges arrive clamped to >= 0; invalid edges carry wa = 0 and nodes
// without a prior wm = 0, and add nothing.
//
// Design. One lane per (node, edge slot): a node's E slots take a group
// of G lanes, G the power of two >= E (E <= 32; the spare lanes add
// nothing), so at E = 8 a warp holds 4 nodes and N = 512 gives 4096
// lanes in 128 blocks, where the old kernel ran 512 threads on 8 SMs.
// Each node's sums (the 10 distinct values of M[i, i]'s edge part, b_i
// and r.r) are reduced over its lanes with __shfl_xor_sync; the group's
// first lane adds M[i, i] with 8-byte vector atomics and b_i. Each valid
// edge's lane adds only the entries of M[i, j], M[j, i], M[j, j] and
// b[j] that are not zero by construction: 9 + 9 + 3 + 3, where the old
// kernel stored 4 dense 6x6 blocks per edge (864 scattered stores per
// node, 2.0 MB at N = 512) for the caller to segment-sum and permute.
// What bounds it is its launch and the atomics' latency: it moves
// ~0.1 MB (0.0001 ms at 3.35 TB/s) and takes ~0.003 ms on the H100
// (PERF.md, kernel table). Atomics make the sum order vary from run to
// run, as the index_add_ they replace did on the card.

#include "accumulate.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads) arap_term_accumulate_kernel(
    const float* __restrict__ nodes, const float* __restrict__ R,
    const float* __restrict__ t, const int32_t* __restrict__ edges,
    const float* __restrict__ wa, const float* __restrict__ wm,
    const float* __restrict__ mt, int N, int E, int log2G,
    float* __restrict__ M, float* __restrict__ bvec,
    float* __restrict__ sq) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int G = 1 << log2G;
  const int64_t node = gid >> log2G;
  const int k = (int)(gid & (G - 1));
  const bool node_ok = node < N;
  const int i = node_ok ? (int)node : 0;
  int j = i;
  float w = 0.f;
  if (node_ok && k < E) {
    j = min(max(edges[(int64_t)i * E + k], 0), N - 1);
    w = wa[(int64_t)i * E + k];
  }
  float Ri[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) Ri[c] = __ldg(R + 9 * (int64_t)i + c);
  float gi[3], ti[3], gj[3], tj[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gi[c] = __ldg(nodes + 3 * (int64_t)i + c);
    ti[c] = __ldg(t + 3 * (int64_t)i + c);
    gj[c] = __ldg(nodes + 3 * (int64_t)j + c);
    tj[c] = __ldg(t + 3 * (int64_t)j + c);
  }
  const float d[3] = {gj[0] - gi[0], gj[1] - gi[1], gj[2] - gi[2]};
  float rho[3], r[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    rho[a] = Ri[3 * a] * d[0] + Ri[3 * a + 1] * d[1] + Ri[3 * a + 2] * d[2];
    r[a] = w * (rho[a] + gi[a] + ti[a] - gj[a] - tj[a]);
  }
  const float w2 = w * w;
  float rsq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];

  // the node's sums over its lanes: M[i, i]'s rotation block (xx, yy,
  // zz, xy, xz, yz), wa^2 rho, wa^2, then b_i
  float acc[16] = {
      w2 * (rho[1] * rho[1] + rho[2] * rho[2]),
      w2 * (rho[0] * rho[0] + rho[2] * rho[2]),
      w2 * (rho[0] * rho[0] + rho[1] * rho[1]),
      -w2 * (rho[0] * rho[1]),
      -w2 * (rho[0] * rho[2]),
      -w2 * (rho[1] * rho[2]),
      w2 * rho[0], w2 * rho[1], w2 * rho[2], w2,
      w * (rho[1] * r[2] - rho[2] * r[1]),
      w * (rho[2] * r[0] - rho[0] * r[2]),
      w * (rho[0] * r[1] - rho[1] * r[0]),
      w * r[0], w * r[1], w * r[2]};
  for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 16; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
  }

  const int64_t ld = 6 * (int64_t)N;
  if (node_ok && k == 0) {
    const float wmi = wm[i];
    float bt[3] = {acc[13], acc[14], acc[15]};
    if (wmi != 0.f) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rm = wmi * (gi[c] + ti[c] - mt[3 * (int64_t)i + c]);
        rsq += rm * rm;
        bt[c] += wmi * rm;
      }
    }
    if (acc[9] != 0.f || wmi != 0.f) {
      const float S[3][3] = {{acc[0], acc[3], acc[4]},
                             {acc[3], acc[1], acc[5]},
                             {acc[4], acc[5], acc[2]}};
      const float* Pv = acc + 6;
      const float W = acc[9] + wmi * wmi;
#pragma unroll
      for (int row = 0; row < 3; ++row) {
        float* dst = block_row(M, ld, i, i, row);
        add2(dst, S[row][0], S[row][1]);
        add2(dst + 2, S[row][2], hat_entry(Pv, row, 0));
        add2(dst + 4, hat_entry(Pv, row, 1), hat_entry(Pv, row, 2));
      }
      float* d3 = block_row(M, ld, i, i, 3);
      add2(d3, 0.f, -hat_entry(Pv, 0, 1));
      add2(d3 + 2, -hat_entry(Pv, 0, 2), W);
      float* d4 = block_row(M, ld, i, i, 4);
      add2(d4, -hat_entry(Pv, 1, 0), 0.f);
      add2(d4 + 2, -hat_entry(Pv, 1, 2), 0.f);
      add2(d4 + 4, W, 0.f);
      float* d5 = block_row(M, ld, i, i, 5);
      add2(d5, -hat_entry(Pv, 2, 0), -hat_entry(Pv, 2, 1));
      add2(d5 + 4, 0.f, W);
      float* bo = bvec + 6 * (int64_t)i;
      add2(bo, acc[10], acc[11]);
      add2(bo + 2, acc[12], bt[0]);
      add2(bo + 4, bt[1], bt[2]);
    }
  }

  if (w != 0.f) {
    // M[i, j]: rotation rows a, columns 3 + c: -wa^2 hat(rho)[a][c];
    // translation rows 3 + c, column 3 + c: -wa^2. M[j, i] is its
    // transpose; M[j, j] has wa^2 on its translation diagonal.
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float* dij = block_row(M, ld, i, j, a);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c == a) continue;
        const float v = -w2 * hat_entry(rho, a, c);
        atomicAdd(dij + 3 + c, v);
        atomicAdd(block_row(M, ld, j, i, 3 + c) + a, v);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      atomicAdd(block_row(M, ld, i, j, 3 + c) + 3 + c, -w2);
      atomicAdd(block_row(M, ld, j, i, 3 + c) + 3 + c, -w2);
      atomicAdd(block_row(M, ld, j, j, 3 + c) + 3 + c, w2);
      atomicAdd(bvec + 6 * (int64_t)j + 3 + c, -w * r[c]);
    }
  }

  rsq = warp_sum(rsq);
  if ((threadIdx.x & 31) == 0) atomicAdd(sq, rsq);
}

}  // namespace

extern "C" int of_arap_term_accumulate(const void* nodes, const void* R,
                                       const void* t, const void* edges,
                                       const void* wa, const void* wm,
                                       const void* motion_targets, int N,
                                       int E, void* M, void* b, void* sq,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return 0;
  if (E < 0 || E > 32) return static_cast<int>(cudaErrorInvalidValue);
  int log2G = 0;
  while ((1 << log2G) < E) ++log2G;
  const int64_t lanes = (int64_t)N << log2G;
  const int blocks = (int)((lanes + kThreads - 1) / kThreads);
  arap_term_accumulate_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(nodes), static_cast<const float*>(R),
      static_cast<const float*>(t), static_cast<const int32_t*>(edges),
      static_cast<const float*>(wa), static_cast<const float*>(wm),
      static_cast<const float*>(motion_targets), N, E, log2G,
      static_cast<float*>(M), static_cast<float*>(b),
      static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}
