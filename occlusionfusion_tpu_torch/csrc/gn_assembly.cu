// Gauss-Newton point term, accumulated in place (K3').
//
// Replaces the TPU kernel
// occlusionfusion_tpu/ops/gn_assembly.py::point_term_blocks_pallas
// (_assembly_kernel) together with the caller's scatter of its blocks:
// it adds the point term straight into the dense normal equations
// M [6N, 6N], b [6N] and sq, as the JAX package's
// solvers/gauss_newton_dense.py::_assemble_blocks(assembly="blocks")
// does. It follows that XLA path, not the TPU kernel, for fractional
// point weights: the warp blends with the raw skinning weights w_k, the
// jacobian uses the gated weights wg_k = w_k * pv, and the residual
// carries pv once. Per point p with anchors a_k:
//   l_k = R_k (x - g_k),  H_k = -hat(l_k)
//   J_k = sw wg_k [H_k | I]                                   [3 x 6]
//   r   = sw pv (sum_k w_k (l_k + g_k + t_k) - y)              [3]
//   M[a_k, a_l] += J_k^T J_l
//               = sw^2 wg_k wg_l [[(l_k.l_l) I - l_l l_k^T, hat(l_k)],
//                                 [-hat(l_l),                I      ]]
//   b[a_k] += J_k^T r = sw wg_k [l_k x r; r],   sq += r.r
//
// Design. A block takes 32 points. Its first warp computes each point's
// compact terms (l_k, wg_k, anchors: 20 values) into shared memory and
// adds b and r.r. Then the four warps share the points; for each, the
// 32 lanes take its 16 anchor pairs x 6 block rows (3 rows a lane) and
// add each row with three 8-byte vector atomics, skipping the pairs
// that are structurally zero (identity off-diagonals: the translation
// rows need 2 of the 3) and every pair whose wg_k wg_l is 0 (padded
// points, points without a target). No per-point block reaches device
// memory: the old kernel stored 2.4 KB per point (19.7 MB at P = 8192)
// that the caller segment-summed, zero-filled a 37.7 MB table for and
// permuted. At P = 8192 the grid is 256 blocks of 4 warps, so all 132
// SMs have work.
//
// What bounds it is the count of its atomics, ~2.1M vector adds at
// P = 8192, far above its byte bound (the touched blocks of M, ~0.6 MB):
// on the H100 it takes ~0.039 ms where ~30 points share each anchor
// pair and ~0.032 ms where pairs are spread, so contention adds ~20%
// (PERF.md, kernel table). Sending a row's three adds side by side in
// one instruction was slower. Atomics rather than a sorted,
// segment-reduced scatter (the JAX package's PairScatterPlan): a sort
// and a segment pass per frame would add launches to a frame the host
// already bounds. Atomics make the sum order vary from run to run, as
// the index_add_ they replace did on the card; the parity checks hold
// at their stated bounds.

#include "accumulate.cuh"

namespace {

constexpr int kPoints = 32;  // points per block
constexpr int kWarps = 4;
constexpr int kK = 4;

__global__ void __launch_bounds__(kWarps * 32) point_term_accumulate_kernel(
    const float* __restrict__ pts, const float* __restrict__ tgt,
    const float* __restrict__ pv, const int32_t* __restrict__ anchors,
    const float* __restrict__ weights, const float* __restrict__ nodes,
    const float* __restrict__ R, const float* __restrict__ t, float sw,
    int P, int N, float* __restrict__ M, float* __restrict__ bvec,
    float* __restrict__ sq) {
  __shared__ float s_l[kPoints][3 * kK + 1];  // +1: no bank conflicts
  __shared__ float s_wg[kPoints][kK];
  __shared__ int s_a[kPoints][kK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // phase 1 (first warp): one point per lane
  if (warp == 0) {
    const int64_t p = (int64_t)blockIdx.x * kPoints + lane;
    float rsq = 0.f;
    if (p < P) {
      const float x[3] = {pts[3 * p], pts[3 * p + 1], pts[3 * p + 2]};
      const float pvp = pv[p];
      float warped[3] = {0.f, 0.f, 0.f};
      float l[kK][3];
      int a[kK];
      float wg[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        a[k] = min(max(anchors[p * kK + k], 0), N - 1);
        const float w = weights[p * kK + k];
        const float* Rk = R + 9 * (int64_t)a[k];
        const float* g = nodes + 3 * (int64_t)a[k];
        const float* tk = t + 3 * (int64_t)a[k];
        const float d[3] = {x[0] - __ldg(g), x[1] - __ldg(g + 1),
                            x[2] - __ldg(g + 2)};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          l[k][i] = __ldg(Rk + 3 * i) * d[0] + __ldg(Rk + 3 * i + 1) * d[1] +
                    __ldg(Rk + 3 * i + 2) * d[2];
          warped[i] += w * (l[k][i] + __ldg(g + i) + __ldg(tk + i));
        }
        wg[k] = w * pvp;
      }
      const float spv = sw * pvp;
      float r[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) r[i] = spv * (warped[i] - tgt[3 * p + i]);
      rsq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
#pragma unroll
      for (int k = 0; k < kK; ++k) {
#pragma unroll
        for (int i = 0; i < 3; ++i) s_l[lane][3 * k + i] = l[k][i];
        s_wg[lane][k] = wg[k];
        s_a[lane][k] = a[k];
        if (wg[k] == 0.f) continue;
        const float c = sw * wg[k];
        float* bo = bvec + 6 * (int64_t)a[k];
        add2(bo, c * (l[k][1] * r[2] - l[k][2] * r[1]),
             c * (l[k][2] * r[0] - l[k][0] * r[2]));
        add2(bo + 2, c * (l[k][0] * r[1] - l[k][1] * r[0]), c * r[0]);
        add2(bo + 4, c * r[1], c * r[2]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kK; ++k) s_wg[lane][k] = 0.f;
    }
    rsq = warp_sum(rsq);
    if (lane == 0) atomicAdd(sq, rsq);
  }
  __syncthreads();

  // phase 2: each warp takes every kWarps-th point of the block; lane
  // unit u = lane + 32 rep covers block row u / 16 of anchor pair u % 16
  const int64_t ld = 6 * (int64_t)N;
  const float sw2 = sw * sw;
  for (int q = warp; q < kPoints; q += kWarps) {
    if (s_wg[q][0] == 0.f && s_wg[q][1] == 0.f && s_wg[q][2] == 0.f &&
        s_wg[q][3] == 0.f)
      continue;
#pragma unroll
    for (int rep = 0; rep < 3; ++rep) {
      const int u = lane + 32 * rep;
      const int row = u >> 4;
      const int k = (u >> 2) & 3;
      const int l = u & 3;
      const float s = sw2 * s_wg[q][k] * s_wg[q][l];
      if (s == 0.f) continue;
      const float* A = s_l[q] + 3 * k;  // l_k
      const float* B = s_l[q] + 3 * l;  // l_l
      float* dst = block_row(M, ld, s_a[q][k], s_a[q][l], row);
      float v[6];
      if (row < 3) {
        const int i1 = (row + 1) % 3, i2 = (row + 2) % 3;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          v[j] = (j == row) ? s * (A[i1] * B[i1] + A[i2] * B[i2])
                            : -s * (B[row] * A[j]);
          v[3 + j] = s * hat_entry(A, row, j);
        }
        add2(dst, v[0], v[1]);
        add2(dst + 2, v[2], v[3]);
        add2(dst + 4, v[4], v[5]);
      } else {
        const int r = row - 3;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          v[j] = -s * hat_entry(B, r, j);
          v[3 + j] = (j == r) ? s : 0.f;
        }
        add2(dst, v[0], v[1]);
        if (r != 2) add2(dst + 2, v[2], v[3]);
        if (r != 0) add2(dst + 4, v[4], v[5]);
      }
    }
  }
}

}  // namespace

extern "C" int of_point_term_accumulate(const void* pts, const void* tgt,
                                        const void* pv, const void* anchors,
                                        const void* weights, const void* nodes,
                                        const void* R, const void* t, float sw,
                                        int P, int N, void* M, void* b,
                                        void* sq, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (P <= 0) return 0;
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + kPoints - 1) / kPoints;
  point_term_accumulate_kernel<<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const float*>(pts), static_cast<const float*>(tgt),
      static_cast<const float*>(pv), static_cast<const int32_t*>(anchors),
      static_cast<const float*>(weights), static_cast<const float*>(nodes),
      static_cast<const float*>(R), static_cast<const float*>(t), sw, P, N,
      static_cast<float*>(M), static_cast<float*>(b),
      static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}
