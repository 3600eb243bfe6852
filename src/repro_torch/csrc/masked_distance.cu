// Dense label-masked distance matrix for Hopper (sm_90a).
//
// Replaces src/repro/kernels/masked_distance.py::masked_distance_pallas:
//
//   out[i, j] = dist(q_i, x_j)  if lq_i ⊆ lx_j
//             = +inf            otherwise
//
// for every query i < Q and row j < N, with dist the norms form
// (‖q‖² − 2·ip) + ‖x‖² (l2) or −ip (ip), summed as dense_tile.cuh sets out.
// The port's callers are the IVF backend's two passes (rows and centroids).
//
// Bound on the card.  2·Q·N·D flops against 4·(Q·N + (Q + N)·(D + W))
// bytes: at D = 128 the [Q, N] output alone is 4 bytes per 256 flops, so
// for Q ≥ 16 the operations bound it (67 TFLOP/s f32 on the CUDA cores; the
// rounded multiply and add are two instructions where an FMA is one, so
// this kernel can reach half of that at most).  At the IVF top tier
// ([256, 10^6], D = 128) that is about 1.0 ms on operations against 0.3 ms
// for the 1 GB output.
// Design: one block per [BQ, 128] output tile (BQ = 16 for Q ≤ 16, else
// 64), queries on gridDim.x and row tiles on gridDim.y; each thread writes
// its BQ/16 × 8 outputs straight from registers, 16 consecutive rows per
// half-warp.  Rows past N and queries past Q are never written: no padding.
#include <cuda_runtime.h>

#include "dense_tile.cuh"

namespace {

template <int BQ, bool L2>
__global__ void __launch_bounds__(dense::kThreads) masked_distance_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    const int* __restrict__ lq, const int* __restrict__ lx,
    float* __restrict__ out, int Q, int N, int D, int W) {
  __shared__ dense::Smem<BQ> s;
  const int q0 = blockIdx.x * BQ, n0 = blockIdx.y * dense::BN;
  float d[BQ / 16][dense::TN];
  dense::tile<BQ, L2>(q, x, lq, lx, Q, N, D, W, q0, n0, s, d);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < BQ / 16; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= Q) continue;
#pragma unroll
    for (int b = 0; b < dense::TN; ++b) {
      const int n = n0 + tx + 16 * b;
      if (n < N) out[static_cast<long long>(qi) * N + n] = d[a][b];
    }
  }
}

template <int BQ>
void launch(bool l2, dim3 grid, cudaStream_t st, const float* q,
            const float* x, const int* lq, const int* lx, float* out, int Q,
            int N, int D, int W) {
  if (l2)
    masked_distance_kernel<BQ, true><<<grid, dense::kThreads, 0, st>>>(
        q, x, lq, lx, out, Q, N, D, W);
  else
    masked_distance_kernel<BQ, false><<<grid, dense::kThreads, 0, st>>>(
        q, x, lq, lx, out, Q, N, D, W);
}

}  // namespace

// q [Q, D] f32, x [N, D] f32, lq [Q, W] i32, lx [N, W] i32 -> out [Q, N]
// f32 (Q, N ≥ 1; N ≤ 65,535·128 row tiles on gridDim.y).  Returns
// cudaGetLastError().
extern "C" int masked_distance(const float* q, const float* x, const int* lq,
                               const int* lx, float* out, int Q, int N, int D,
                               int W, int metric_ip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool l2 = metric_ip == 0;
  const int ntiles = (N + dense::BN - 1) / dense::BN;
  if (Q <= 16)
    launch<16>(l2, dim3((Q + 15) / 16, ntiles), st, q, x, lq, lx, out, Q, N,
               D, W);
  else
    launch<64>(l2, dim3((Q + 63) / 64, ntiles), st, q, x, lq, lx, out, Q, N,
               D, W);
  return static_cast<int>(cudaGetLastError());
}
