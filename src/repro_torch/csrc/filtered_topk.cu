// Dense label-filtered top-k for Hopper (sm_90a).
//
// Replaces src/repro/kernels/filtered_topk.py::filtered_topk_pallas: for
// every query i < Q, the k smallest (d[i, j], j) pairs over the rows j < N
// that pass the label filter, in (value, row) order with values in IEEE
// total order; slots past the last passing row are (+inf, N).  d is the
// tile of dense_tile.cuh, bit for bit the value masked_distance.cu writes.
// The port's caller is the private-copy FlatIndex (the whole-dataset
// PostFiltering scan when no index is selected).
//
// Bound on the card.  2·Q·N·D flops against 4·((Q + N)·(D + W) + 2·Q·k)
// bytes: no [Q, N] matrix reaches device memory, so the operations bound
// it (at [1024, 10^6], D = 128: about 3.9 ms at 67 TFLOP/s f32 against
// 0.16 ms of bytes; the tile's FMA chains can reach that rate).
// Design.  The TPU kernel's k rounds of min/argmin per tile, carried across
// a sequential grid, do not carry over: blocks run in parallel and nothing
// is carried between them.  Instead:
//   * a block owns (a tile of BQ queries, a span of N) and walks the span
//     in [BQ, 128] tiles (dense_tile.cuh: a cp.async ring of 16 features
//     a stage, BQ/16 × 8 FMA chains a thread; BQ = 16 for Q ≤ 16, else
//     64); each finished tile goes to shared memory, in the ring's place;
//   * warp w keeps the sorted k-pools of its BQ/8 queries in registers,
//     one pool slot per lane (k ≤ 32).  A tile row is offered 32 rows at a
//     time: a ballot against the pool's k-th key admits the few that beat
//     it (after the first tiles almost none do), and each admitted row is
//     inserted by rank (a ballot and one shuffle);
//   * each span's pools are written as partials [Q, splits, k]; a second
//     kernel, one warp per query, merges them the same way.  Keys are
//     unique (rows are) and the order is total, so the split changes no bit.
#include <cuda_runtime.h>

#include "dense_tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// One query's pool, held across a warp: lane l keeps slot l (l < k) of the
// (value, row) keys in ascending order; cnt (warp-uniform) slots are used.
struct WarpPool {
  float v;
  int p;
  int cnt;

  __device__ void init(int sentinel) {
    v = scan::inf();
    p = sentinel;
    cnt = 0;
  }

  // Every lane offers one (value, row); +inf offers nothing.  All 32 lanes
  // of the warp must call it.
  __device__ void offer(float cv, int cp, int k) {
    const int lane = threadIdx.x & 31;
    float tv = __shfl_sync(kFull, v, k - 1);
    int tp = __shfl_sync(kFull, p, k - 1);
    const bool want =
        cv < scan::inf() && (cnt < k || scan::key_less(cv, cp, tv, tp));
    unsigned m = __ballot_sync(kFull, want);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float nv = __shfl_sync(kFull, cv, src);
      const int np = __shfl_sync(kFull, cp, src);
      tv = __shfl_sync(kFull, v, k - 1);
      tp = __shfl_sync(kFull, p, k - 1);
      if (cnt == k && !scan::key_less(nv, np, tv, tp)) continue;
      const bool below = lane < cnt && scan::key_less(v, p, nv, np);
      const int rank = __popc(__ballot_sync(kFull, below));
      const float up_v = __shfl_up_sync(kFull, v, 1);
      const int up_p = __shfl_up_sync(kFull, p, 1);
      if (lane == rank) {
        v = nv;
        p = np;
      } else if (lane > rank) {
        v = up_v;
        p = up_p;
      }
      cnt = min(cnt + 1, k);
    }
  }

  __device__ void emit(float* out_v, int* out_p, int k, int sentinel) const {
    const int lane = threadIdx.x & 31;
    if (lane < k) {
      out_v[lane] = lane < cnt ? v : scan::inf();
      out_p[lane] = lane < cnt ? p : sentinel;
    }
  }
};

constexpr int BN = 128;  // rows of a tile

// two blocks an SM (launch bound): in exploratory builds on an H100 the
// unbounded kernel took 168 registers, one block an SM, and ran far
// slower at [1024, 10^6]
template <int BQ, bool L2>
__global__ void __launch_bounds__(dense::kThreads, 2) filtered_topk_partial(
    const float* __restrict__ q, const float* __restrict__ x,
    const int* __restrict__ lq, const int* __restrict__ lx,
    float* __restrict__ out_v, int* __restrict__ out_p, int Q, int N, int D,
    int W, int k, int span, int splits, bool vec) {
  constexpr int R = BQ / 8;  // queries per warp
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<dense::Smem<BQ, BN>*>(smem);
  const int q0 = blockIdx.x * BQ, sp = blockIdx.y;
  const int lo = sp * span, hi = min(lo + span, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  WarpPool pool[R];
#pragma unroll
  for (int r = 0; r < R; ++r) pool[r].init(N);

  for (int n0 = lo; n0 < hi; n0 += BN) {
    float d[BQ / 16][BN / 16];
    dense::tile<BQ, BN, L2>(q, x, lq, lx, Q, hi, D, W, q0, n0, vec, s, d);
#pragma unroll
    for (int a = 0; a < BQ / 16; ++a)
#pragma unroll
      for (int b = 0; b < BN / 16; ++b)
        s.u.d[ty + 16 * a][tx + 16 * b] = d[a][b];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + 8 * r;
      if (q0 + row >= Q) continue;  // warp-uniform
#pragma unroll
      for (int c = 0; c < BN; c += 32)
        pool[r].offer(s.u.d[row][c + lane], n0 + c + lane, k);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp + 8 * r;
    if (qi >= Q) continue;
    const long long o = (static_cast<long long>(qi) * splits + sp) * k;
    pool[r].emit(out_v + o, out_p + o, k, N);
  }
}

// one warp per query: merge its `splits` partial pools into the final k
__global__ void __launch_bounds__(dense::kThreads) filtered_topk_merge(
    const float* __restrict__ part_v, const int* __restrict__ part_p,
    float* __restrict__ out_v, int* __restrict__ out_p, int Q, int N, int k,
    int splits) {
  const int qi = blockIdx.x * (dense::kThreads / 32) + threadIdx.x / 32;
  if (qi >= Q) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int total = splits * k;
  const long long o = static_cast<long long>(qi) * total;
  WarpPool pool;
  pool.init(N);
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    const bool has = i < total;
    pool.offer(has ? part_v[o + i] : scan::inf(), has ? part_p[o + i] : N, k);
  }
  pool.emit(out_v + static_cast<long long>(qi) * k,
            out_p + static_cast<long long>(qi) * k, k, N);
}

template <int BQ>
cudaError_t launch_partial(bool l2, dim3 grid, cudaStream_t st,
                           const float* q, const float* x, const int* lq,
                           const int* lx, float* pv, int* pp, int Q, int N,
                           int D, int W, int k, int span, int splits) {
  constexpr int bytes = sizeof(dense::Smem<BQ, BN>);
  static bool opted_l2 = false, opted_ip = false;
  const cudaError_t err =
      l2 ? dense::allow_smem(filtered_topk_partial<BQ, true>, bytes, opted_l2)
         : dense::allow_smem(filtered_topk_partial<BQ, false>, bytes,
                             opted_ip);
  if (err != cudaSuccess) return err;
  const bool vec = dense::vec_ok(q, x, D);
  if (l2)
    filtered_topk_partial<BQ, true><<<grid, dense::kThreads, bytes, st>>>(
        q, x, lq, lx, pv, pp, Q, N, D, W, k, span, splits, vec);
  else
    filtered_topk_partial<BQ, false><<<grid, dense::kThreads, bytes, st>>>(
        q, x, lq, lx, pv, pp, Q, N, D, W, k, span, splits, vec);
  return cudaGetLastError();
}

}  // namespace

// q [Q, D] f32, x [N, D] f32, lq [Q, W] i32, lx [N, W] i32 -> out_v [Q, k]
// f32, out_p [Q, k] i32 (Q, N ≥ 1, 1 ≤ k ≤ 32; span a multiple of 128,
// splits = ⌈N / span⌉ ≤ 65,535).  With splits > 1, part_v/part_p
// [Q, splits, k] are the per-span scratch.  Returns cudaGetLastError().
extern "C" int filtered_topk(const float* q, const float* x, const int* lq,
                             const int* lx, float* part_v, int* part_p,
                             float* out_v, int* out_p, int Q, int N, int D,
                             int W, int k, int span, int splits,
                             int metric_ip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool l2 = metric_ip == 0;
  float* pv = splits > 1 ? part_v : out_v;
  int* pp = splits > 1 ? part_p : out_p;
  const cudaError_t err =
      Q <= 16 ? launch_partial<16>(l2, dim3((Q + 15) / 16, splits), st, q, x,
                                   lq, lx, pv, pp, Q, N, D, W, k, span,
                                   splits)
              : launch_partial<64>(l2, dim3((Q + 63) / 64, splits), st, q, x,
                                   lq, lx, pv, pp, Q, N, D, W, k, span,
                                   splits);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int per_block = dense::kThreads / 32;
  filtered_topk_merge<<<(Q + per_block - 1) / per_block, dense::kThreads, 0,
                        st>>>(part_v, part_p, out_v, out_p, Q, N, k, splits);
  return static_cast<int>(cudaGetLastError());
}
