// Brute-force k-nearest-neighbour search (K1).
//
// Replaces the TPU kernel occlusionfusion_tpu/ops/knn.py::knn_pallas
// (_knn_kernel): d2 = |q|^2 - 2 q.r + |r|^2 + bias (bias 1e30 on invalid
// refs), k rounds of argmin, d2 clamped >= 0.
//
// Bound: f32 operations. Counting what the inputs need, P queries x
// N_valid refs x 7 flop (an FMA counts 2): 2M voxels x 297 valid nodes
// is 4.4 GFLOP, 0.065 ms at 67 TFLOP/s. The FP pipe issues ~3.5
// FMA-equivalents per pair, so about twice that is the practical floor.
//
// Design:
//  * Each block stages the refs once in shared memory, compacted to the
//    valid ones in ascending index order (a warp ballot and a prefix over
//    the block), each as (-2x, -2y, -2z, |r|^2) with its original index
//    beside it. Invalid refs cost nothing, and the ascending order keeps
//    the strict-< rule: among equal distances the lower index stays
//    first, as the stable sort of the twin knn_torch orders them.
//  * Scaling by -2 is exact, so fma(qz, -2rz, fma(qy, -2ry, qx*(-2rx)))
//    is -2 q.r bit for bit and d = (|q|^2 + that) + |r|^2 rounds as the
//    twin's ((|q|^2 - 2 q.r) + |r|^2) + 0 (ops/knn.py documents why the
//    order matters): 5 FP instructions per pair and no per-pair bias.
//  * With fewer than k valid refs the last slots take the lowest-index
//    invalid refs at d2 = 1e30, which is what the twin's bias gives them.
//  * Each thread holds kQ = 2 queries (lanes on neighbouring queries),
//    so one broadcast 16-byte shared load of a ref feeds 2 pairs. The
//    sorted k-list of each query (distances, and positions among the
//    compacted refs, mapped to indices at the end) stays in registers
//    and is updated without branches; for each query slot the warp skips
//    the update when none of its 32 queries beats its current k-th best.
//    That update, not the distances, is what the time beyond the bound
//    goes to where a warp's queries have different neighbours: one vote
//    per slot runs it less often than one vote per thread. ptxas gives
//    39 registers and no spills; 4 queries per thread took 70 registers
//    and ran no faster on an H100 (0.485 against 0.479 ms on random queries).
//  * The launcher sizes the grid: blocks of 128 threads, halved (down to
//    one warp) while the grid would give fewer than 4 blocks per SM, so
//    that the model-point call (8192 queries) still spreads over the
//    card.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int K = 4;  // anchors per query: the skinning's GRAPH_K
constexpr int kQ = 2;  // queries per thread
constexpr float kBig = 1e30f;

__global__ void knn_kernel(const float* __restrict__ q,
                           const float* __restrict__ r,
                           const uint8_t* __restrict__ valid, int P, int N,
                           float* __restrict__ d2_out,
                           int32_t* __restrict__ idx_out) {
  extern __shared__ float4 smem[];
  float4* refs = smem;                                // [N] compacted
  int* ref_idx = reinterpret_cast<int*>(smem + N);    // [N] their indices
  __shared__ int warp_counts[32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // compaction of the valid refs, chunk by chunk in ascending order
  int base_out = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int n = base + threadIdx.x;
    const bool ok = n < N && (valid == nullptr || valid[n] != 0);
    const unsigned ball = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_counts[warp] = __popc(ball);
    __syncthreads();
    int before = base_out;
    int total = base_out;
    for (int w = 0; w < n_warps; ++w) {
      const int c = warp_counts[w];
      if (w < warp) before += c;
      total += c;
    }
    if (ok) {
      const int slot = before + __popc(ball & ((1u << lane) - 1u));
      const float x = r[3 * n + 0], y = r[3 * n + 1], z = r[3 * n + 2];
      // |r|^2 = (x*x + y*y) + z*z, each op rounded
      const float rsq =
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                    __fmul_rn(z, z));
      refs[slot] = make_float4(-2.f * x, -2.f * y, -2.f * z, rsq);
      ref_idx[slot] = n;
    }
    base_out = total;
    __syncthreads();
  }
  const int n_valid = base_out;

  // queries of this thread: lanes on neighbouring queries for each j
  const int64_t first = (int64_t)blockIdx.x * blockDim.x * kQ + threadIdx.x;
  float qx[kQ], qy[kQ], qz[kQ], qsq[kQ];
  float bd[kQ][K];
  int bi[kQ][K];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int64_t p = first + (int64_t)j * blockDim.x;
    qx[j] = qy[j] = qz[j] = 0.f;
    if (p < P) {
      qx[j] = q[3 * p + 0];
      qy[j] = q[3 * p + 1];
      qz[j] = q[3 * p + 2];
    }
    // |q|^2 = fma(qz, qz, fma(qy, qy, qx*qx))
    qsq[j] = fmaf(qz[j], qz[j], fmaf(qy[j], qy[j], __fmul_rn(qx[j], qx[j])));
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[j][s] = INFINITY;
      bi[j][s] = 0;
    }
  }

#pragma unroll 2
  for (int i = 0; i < n_valid; ++i) {
    const float4 rr = refs[i];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const float m2dot =
          fmaf(qz[j], rr.z, fmaf(qy[j], rr.y, __fmul_rn(qx[j], rr.x)));
      const float d = __fadd_rn(__fadd_rn(qsq[j], m2dot), rr.w);
      const bool c3 = d < bd[j][3];
      // one vote per query slot: the update runs when one of the warp's
      // 32 queries of this slot beats its k-th best
      if (__any_sync(0xffffffffu, c3)) {
        const int id = i;  // the position among the compacted refs
        // sorted insertion without branches; strict < keeps the earlier
        // (lower-index) ref first among equal distances
        const bool c0 = d < bd[j][0], c1 = d < bd[j][1], c2 = d < bd[j][2];
        bd[j][3] = c2 ? bd[j][2] : (c3 ? d : bd[j][3]);
        bi[j][3] = c2 ? bi[j][2] : (c3 ? id : bi[j][3]);
        bd[j][2] = c1 ? bd[j][1] : (c2 ? d : bd[j][2]);
        bi[j][2] = c1 ? bi[j][1] : (c2 ? id : bi[j][2]);
        bd[j][1] = c0 ? bd[j][0] : (c1 ? d : bd[j][1]);
        bi[j][1] = c0 ? bi[j][0] : (c1 ? id : bi[j][1]);
        bd[j][0] = c0 ? d : bd[j][0];
        bi[j][0] = c0 ? id : bi[j][0];
      }
    }
  }

  if (n_valid < K) {
    // the lowest-index invalid refs fill the last slots at d2 = 1e30
    if (threadIdx.x == 0) {
      int s = n_valid;
      for (int n = 0; n < N && s < K; ++n) {
        if (valid[n] == 0) ref_idx[s++] = n;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (s >= n_valid) {
          bd[j][s] = kBig;
          bi[j][s] = s;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    const int64_t p = first + (int64_t)j * blockDim.x;
    if (p < P) {
      reinterpret_cast<float4*>(d2_out)[p] =
          make_float4(fmaxf(bd[j][0], 0.f), fmaxf(bd[j][1], 0.f),
                      fmaxf(bd[j][2], 0.f), fmaxf(bd[j][3], 0.f));
      reinterpret_cast<int4*>(idx_out)[p] =
          make_int4(ref_idx[bi[j][0]], ref_idx[bi[j][1]], ref_idx[bi[j][2]],
                    ref_idx[bi[j][3]]);
    }
  }
}

}  // namespace

// valid may be null (every ref valid).
extern "C" int of_knn(const void* q, const void* r, const void* valid, int P,
                      int N, int k, void* d2_out, void* idx_out,
                      void* stream) {
  if (k != K || N < K) return static_cast<int>(cudaErrorInvalidValue);
  if (P <= 0) return 0;
  const size_t smem = (size_t)N * (sizeof(float4) + sizeof(int));
  cudaFuncAttributes fa;
  cudaError_t e;
  int dev = 0, sms = 0, optin = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (e = cudaFuncGetAttributes(&fa, knn_kernel)) != cudaSuccess)
    return static_cast<int>(e);
  if (smem + fa.sharedSizeBytes > (size_t)optin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(knn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = 128;
  while (threads > 32 &&
         ((int64_t)P + threads * kQ - 1) / (threads * kQ) < 4 * (int64_t)sms)
    threads /= 2;
  const int64_t blocks = ((int64_t)P + threads * kQ - 1) / (threads * kQ);
  knn_kernel<<<static_cast<unsigned>(blocks), threads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(r),
      static_cast<const uint8_t*>(valid), P, N, static_cast<float*>(d2_out),
      static_cast<int32_t*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}
