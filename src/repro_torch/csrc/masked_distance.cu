// Dense label-masked distance matrix for Hopper (sm_90a).
//
// Replaces src/repro/kernels/masked_distance.py::masked_distance_pallas:
//
//   out[i, j] = dist(q_i, x_j)  if lq_i ⊆ lx_j
//             = +inf            otherwise
//
// for every query i < Q and row j < N, with dist the norms form
// (‖q‖² − 2·ip) + ‖x‖² (l2) or −ip (ip).  The port's callers are the IVF
// backend's two passes (rows and centroids) and the graph build's
// candidate lists.
//
// Arithmetic contract: dense_tile.cuh's.  Every inner product and norm is
// one chain of FMAs in order over D, so a value is a function of its two
// rows alone (batch buckets and B3 agree bitwise); against the plain
// version, integer data is bitwise and random data within rtol 1e-5.
//
// Bound on the card.  2·Q·N·D flops against 4·(Q·N + (Q + N)·(D + W))
// bytes: at D = 128 the [Q, N] output alone is 4 bytes per 256 flops, so
// for Q ≥ 16 the operations bound it (67 TFLOP/s f32 on the CUDA cores,
// which the FMA chains can reach).  At the IVF top tier ([256, 10^6],
// D = 128) that is about 0.99 ms of operations against 0.31 ms for the
// 1 GB output and 0.15 ms for the rows.
//
// Design.  One block of 256 threads per [BQ, BN] output tile, three
// instances: 128 × 64 (8 × 4 outputs a thread, three blocks an SM) for
// Q > 64, 64 × 128 for 17 ≤ Q ≤ 64, and 16 × 128 for the small routed
// indexes (Q ≤ 16; two blocks an SM each).  In exploratory builds on an
// H100, 128 × 64 at three blocks an SM beat 128 × 128 (8 × 8 a thread,
// two blocks an SM) at [256, 10^6] and [1024, 10^6]: the blocks an SM
// holds, not the loads per FMA, bound the tile.  Query tiles run on
// gridDim.x, the fast axis, so a row tile's query-tile blocks are
// scheduled together and read its rows from device memory once.  The
// tile (dense_tile.cuh) stages rows and queries through a 3-stage
// cp.async ring; the finished tile goes through shared memory, and each
// warp writes whole row segments of the output (BN floats a row) with
// 16-byte streaming stores (__stcs: the 1 GB output does not evict the
// rows from L2), predicated at the Q and N edges (scalar stores where
// N % 4 != 0).
#include <cuda_runtime.h>

#include "dense_tile.cuh"

namespace {

template <int BQ, int BN, int MINB, bool L2>
__global__ void __launch_bounds__(dense::kThreads, MINB)
    masked_distance_kernel(const float* __restrict__ q,
                           const float* __restrict__ x,
                           const int* __restrict__ lq,
                           const int* __restrict__ lx,
                           float* __restrict__ out, int Q, int N, int D,
                           int W, bool vec, bool vec_out) {
  using S = dense::Smem<BQ, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<S*>(smem);
  const int q0 = blockIdx.x * BQ, n0 = blockIdx.y * BN;
  float d[BQ / 16][BN / 16];
  dense::tile<BQ, BN, L2>(q, x, lq, lx, Q, N, D, W, q0, n0, vec, s, d);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
#pragma unroll
  for (int a = 0; a < BQ / 16; ++a)
#pragma unroll
    for (int b = 0; b < BN / 16; ++b)
      s.u.d[ty + 16 * a][tx + 16 * b] = d[a][b];
  __syncthreads();
  // a warp writes RPW whole rows of BN floats at once, 16 bytes a lane
  constexpr int LPR = BN / 4, RPW = 32 / LPR;
  const int lane = t % 32, c = 4 * (lane % LPR), n = n0 + c;
  for (int r = (t / 32) * RPW + lane / LPR; r < BQ && q0 + r < Q;
       r += dense::kThreads / 32 * RPW) {
    float* o = out + static_cast<long long>(q0 + r) * N + n;
    const float4 v = *reinterpret_cast<const float4*>(&s.u.d[r][c]);
    if (vec_out) {
      if (n < N) __stcs(reinterpret_cast<float4*>(o), v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) __stcs(o + j, dense::part(v, j));
    }
  }
}

template <int BQ, int BN, int MINB>
cudaError_t launch(bool l2, cudaStream_t st, const float* q, const float* x,
                   const int* lq, const int* lx, float* out, int Q, int N,
                   int D, int W) {
  constexpr int bytes = sizeof(dense::Smem<BQ, BN>);
  static bool opted_l2 = false, opted_ip = false;
  const cudaError_t err =
      l2 ? dense::allow_smem(masked_distance_kernel<BQ, BN, MINB, true>, bytes,
                             opted_l2)
         : dense::allow_smem(masked_distance_kernel<BQ, BN, MINB, false>,
                             bytes, opted_ip);
  if (err != cudaSuccess) return err;
  const bool vec = dense::vec_ok(q, x, D);
  const bool vec_out =
      N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((Q + BQ - 1) / BQ, (N + BN - 1) / BN);
  if (l2)
    masked_distance_kernel<BQ, BN, MINB, true>
        <<<grid, dense::kThreads, bytes, st>>>(q, x, lq, lx, out, Q, N, D, W,
                                               vec, vec_out);
  else
    masked_distance_kernel<BQ, BN, MINB, false>
        <<<grid, dense::kThreads, bytes, st>>>(q, x, lq, lx, out, Q, N, D, W,
                                               vec, vec_out);
  return cudaGetLastError();
}

}  // namespace

// q [Q, D] f32, x [N, D] f32, lq [Q, W] i32, lx [N, W] i32 -> out [Q, N]
// f32 (Q, N ≥ 1; N ≤ 65,535·128: row tiles on gridDim.y, so past 65,535
// tiles of 64 rows the 64 × 128 instance takes Q > 64 too).  Returns
// cudaGetLastError().
extern "C" int masked_distance(const float* q, const float* x, const int* lq,
                               const int* lx, float* out, int Q, int N, int D,
                               int W, int metric_ip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool l2 = metric_ip == 0;
  cudaError_t err;
  if (Q <= 16)
    err = launch<16, 128, 2>(l2, st, q, x, lq, lx, out, Q, N, D, W);
  else if (Q <= 64 || (N + 63) / 64 > 65535)
    err = launch<64, 128, 2>(l2, st, q, x, lq, lx, out, Q, N, D, W);
  else
    err = launch<128, 64, 3>(l2, st, q, x, lq, lx, out, Q, N, D, W);
  return static_cast<int>(err);
}

// dynamic shared memory of a block of the instance for bq queries
// (chip_smoke.py reports it beside -Xptxas -v)
extern "C" int masked_distance_smem_bytes(int bq) {
  return bq <= 16   ? static_cast<int>(sizeof(dense::Smem<16, 128>))
         : bq <= 64 ? static_cast<int>(sizeof(dense::Smem<64, 128>))
                    : static_cast<int>(sizeof(dense::Smem<128, 64>));
}
