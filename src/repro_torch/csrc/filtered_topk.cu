// Dense label-filtered top-k for Hopper (sm_90a).
//
// Replaces src/repro/kernels/filtered_topk.py::filtered_topk_pallas: for
// every query i < Q, the k smallest (d[i, j], j) pairs over the rows j < N
// that pass the label filter, in (value, row) order with values in IEEE
// total order; slots past the last passing row are (+inf, N).  d is the
// tile of dense_tile.cuh, bit for bit the value masked_distance.cu writes.
// The port's caller is the private-copy FlatIndex (the whole-dataset
// PostFiltering scan when no index is selected).  1 ≤ k ≤ 256.
//
// Bound on the card.  Only the pairs that pass the filter need a
// distance: (2D + 3) flops each, against the bytes of the queries, the
// label words the queries set of every row, the rows that pass some
// filter and the [Q, k] output (no [Q, N] matrix reaches device memory).
// On the paper workload about a fifth of the pairs pass, so the
// operations bound it, and the tile, which computes every pair of its
// [BQ, BN] before the filter, spends about four fifths of its FMAs on
// pairs the filter then drops: skipping them is the open lever.  The tile
// is masked_distance's, so the time B4 takes for the same pairs is the
// yardstick for what the top-k costs on top of it (PERF.md §6 has both
// beside the bound).
//
// Design.  The TPU kernel's k rounds of min/argmin per tile, carried across
// a sequential grid, do not carry over: blocks run in parallel and nothing
// is carried between them.  Instead:
//   * a block owns (a tile of BQ queries, a span of N) and walks the span
//     in [BQ, BN] tiles of dense_tile.cuh: B4's 128 × 64 at three blocks
//     an SM for Q > 64 and k ≤ 32; 32 × 128 (Q ≤ 64 or k > 32) and
//     16 × 128 (Q ≤ 16), three blocks an SM unless the pools' shared
//     memory holds fewer;
//   * the block's queries are fixed for its span, so it tests only the
//     label words up to the last one its queries set (the words past it
//     pass every row): the paper workload's 32 labels use one of its four
//     words;
//   * each query's pool, its k smallest (value, row) keys so far, sorted,
//     lives in shared memory as int64 keys in total order (empty slots
//     (+inf, N)); its k-th key is the query's admission threshold.  No
//     pool is held in registers, so the tile keeps B4's occupancy;
//   * query ty + 16a's tile values lie in the 16 lanes of one half-warp
//     (thread (ty, tx) holds them in registers), so each warp tests and
//     updates its own queries' pools with warp votes and shuffles alone:
//     no block barrier and no pass of the tile through shared memory.  A
//     lane rules a value out against the threshold's value (one compare);
//     a warp with no survivor in a query row goes on at once;
//   * k ≤ 32: a survivor enters its pool by rank (lane l holds slot l:
//     a ballot and a shuffle), after a test against the current k-th
//     key.  k > 32: survivors go to the warp's 32-key buffer (in the
//     ring's place: the ring is idle between tiles), which is merged into
//     the pool before it could overflow and at the end of the query's row
//     (a bitonic sort of the buffer across the warp, then each key moves
//     to its rank in the union).  Keys are unique, so the order of
//     arrival changes no bit, and no candidate is dropped.  The buffer
//     would serve k ≤ 32 too, but there it took 1.8× the insert by rank
//     at [1024, 10^6] and spilled more (PERF.md §6);
//   * after the first tiles of a span almost no value survives: on rows in
//     random order a query admits about k·(1 + ln(n/k)) of a span's n
//     passing rows (~90 at k 10 and 20,000 rows);
//   * each span's pools are written as partials [Q, splits, k]; a second
//     kernel, one warp per query, merges them the same way.  The host
//     sizes the span split from the blocks an SM the instance holds
//     (filtered_topk_blocks_per_sm, the occupancy API), so
//     that the grid ends in whole waves (kernels/filtered_topk.py).
//
// Planted faults (the entry filtered_topk_planted, which only the checks
// call, in the 128 × 64 instance): 1, only the first survivor of each
// ballot enters the pool; 2, the threshold read one slot early (the
// pool's (k-1)-th key).
#include <cuda_runtime.h>

#include "dense_tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int CAP = 32;                        // keys a warp buffers (k > 32)
constexpr long long kNone = 0x7fffffffffffffffLL;  // no candidate: above all

// (value, row) as one int64 whose signed order is the (value, row) order
// with values in IEEE total order (scan::order_key)
__device__ __forceinline__ long long make_key(float v, int row) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(
           static_cast<unsigned>(scan::order_key(v))) << 32) |
      static_cast<unsigned>(row));
}
// scan::order_key is its own inverse on the int bits
__device__ __forceinline__ float key_value(long long key) {
  const int i = static_cast<int>(key >> 32);
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}
__device__ __forceinline__ int key_row(long long key) {
  return static_cast<int>(key & 0xffffffffLL);
}

// One query's pool of k ≤ 32 keys across a warp, for an insert sequence:
// lane l holds slot l (kNone past k).
struct LanePool {
  long long e;

  __device__ void load(const long long* pool, int k) {
    const int lane = threadIdx.x & 31;
    e = lane < k ? pool[lane] : kNone;
  }
  __device__ void store(long long* pool, int k) const {
    const int lane = threadIdx.x & 31;
    if (lane < k) pool[lane] = e;
  }
  // c (the same on every lane) enters at its rank if it beats the key in
  // slot thr_at (k - 1, the pool's k-th); all 32 lanes call it
  __device__ void offer(long long c, int thr_at) {
    const int lane = threadIdx.x & 31;
    if (!(c < __shfl_sync(kFull, e, thr_at))) return;
    const int rank = __popc(__ballot_sync(kFull, e < c));
    const long long up = __shfl_up_sync(kFull, e, 1);
    if (lane == rank)
      e = c;
    else if (lane > rank)
      e = up;
  }
};

// Merge the warp's candidates (lane l holds one key, or kNone; any order,
// every key distinct from the pool's) into pool[0, k) in shared memory,
// sorted ascending: afterwards it holds the k smallest keys of the union,
// sorted.  All 32 lanes call it; KCAP ≥ k is a multiple of 32.
template <int KCAP>
__device__ void merge_into(long long* pool, int k, long long c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const long long o = __shfl_xor_sync(kFull, c, stride);
      const bool take_min = ((lane & stride) == 0) == ((lane & size) == 0);
      c = take_min ? min(c, o) : max(c, o);
    }
  // a pool entry moves right by the candidates below it
  long long keep[KCAP / 32];
  int to[KCAP / 32];
  const long long last = __shfl_sync(kFull, c, 31);
#pragma unroll
  for (int j = 0; j < KCAP / 32; ++j) {
    const int i = lane + 32 * j;
    const long long e = i < k ? pool[i] : kNone;
    int below = 0;
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      const long long probe = __shfl_sync(kFull, c, below + step - 1);
      if (probe < e) below += step;
    }
    below += below == 31 && last < e;
    keep[j] = e;
    to[j] = i + below;
  }
  // a candidate lands at its rank among the candidates (its lane) plus
  // the pool entries below it
  int lo = 0;
  for (int n = k; n > 0;) {
    const int half = n >> 1;
    if (pool[lo + half] < c) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  __syncwarp();  // every lane has read the old pool
#pragma unroll
  for (int j = 0; j < KCAP / 32; ++j)
    if (to[j] < k) pool[to[j]] = keep[j];
  if (c != kNone && lane + lo < k) pool[lane + lo] = c;
  __syncwarp();
}

// The block's shared memory: the tile's (its ring doubles as the warps'
// candidate buffers [8][CAP] between tiles, for k > 32), then the pools
// [BQ][k].
template <int BQ, int BN>
struct Layout {
  using Tile = dense::Smem<BQ, BN>;
  static constexpr int kPools = (sizeof(Tile) + 15) / 16 * 16;
  static_assert(dense::kThreads / 32 * CAP * sizeof(long long) <=
                    sizeof(Tile::u),
                "the candidate buffers fit in the ring");
  __host__ __device__ static constexpr int bytes(int k) {
    return kPools + BQ * k * static_cast<int>(sizeof(long long));
  }
};

// FAULT 0 ships; 1 and 2 are the planted faults of the file's head
template <int BQ, int BN, int MINB, int KCAP, bool L2, int FAULT>
__global__ void __launch_bounds__(dense::kThreads, MINB) filtered_topk_partial(
    const float* __restrict__ q, const float* __restrict__ x,
    const int* __restrict__ lq, const int* __restrict__ lx,
    float* __restrict__ out_v, int* __restrict__ out_p, int Q, int N, int D,
    int W, int k, int span, int splits, bool vec) {
  using L = Layout<BQ, BN>;
  constexpr int TQ = BQ / 16, TN = BN / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<typename L::Tile*>(smem);
  long long* pool = reinterpret_cast<long long*>(smem + L::kPools);
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int warp = t / 32, lane = t & 31;
  long long* wbuf = reinterpret_cast<long long*>(&s.u) + warp * CAP;
  const int q0 = blockIdx.x * BQ, sp = blockIdx.y;
  const int lo = sp * span, hi = min(lo + span, N);
  const int thr_at = FAULT == 2 ? max(k - 2, 0) : k - 1;
  const long long empty = make_key(scan::inf(), N);
  for (int i = t; i < BQ * k; i += dense::kThreads) pool[i] = empty;
  // (the tile's leading barrier orders these before every reader)
  // Label words past the last one that some query of the block sets pass
  // every row: the tiles of the span test only the words before it (one
  // of the paper workload's four).
  int wt = 0;
  for (int w = W - 1; w >= 0 && wt == 0; --w)
    if (__syncthreads_or(t < BQ && q0 + t < Q &&
                         lq[static_cast<long long>(q0 + t) * W + w] != 0))
      wt = w + 1;

  for (int n0 = lo; n0 < hi; n0 += BN) {
    float d[TQ][TN];
    dense::tile<BQ, BN, L2>(q, x, lq, lx, Q, hi, D, W, wt, q0, n0, vec, s,
                            d);
    // Query ty + 16a's values lie in the 16 lanes of one half-warp, so a
    // warp tests and updates its own queries' pools: no block barrier.
#pragma unroll
    for (int a = 0; a < TQ; ++a) {
      const int r = ty + 16 * a;
      const bool live = q0 + r < Q;
      const float thv = key_value(pool[r * k + thr_at]);
      bool pass[TN];
      bool any = false;
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        // the value alone rules out what cannot beat the threshold key
        pass[b] = live && d[a][b] < scan::inf() && d[a][b] <= thv;
        any = any || pass[b];
      }
      const unsigned halves = __ballot_sync(kFull, any);
      if (halves == 0) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned hm = 0xffffu << (16 * h);
        if ((halves & hm) == 0) continue;
        long long* pq = pool + (2 * warp + h + 16 * a) * k;
        if constexpr (KCAP == 32) {
          LanePool lp;
          lp.load(pq, k);
#pragma unroll
          for (int b = 0; b < TN; ++b) {
            unsigned m = __ballot_sync(kFull, pass[b]) & hm;
            while (m) {
              const int src = __ffs(m) - 1;
              m &= m - 1;
              const float v = __shfl_sync(kFull, d[a][b], src);
              lp.offer(make_key(v, n0 + (src & 15) + 16 * b), thr_at);
              if (FAULT == 1) break;
            }
          }
          lp.store(pq, k);
        } else {
          // survivors go to the warp's buffer, merged before it could
          // overflow and at the end
          int n = 0;
#pragma unroll
          for (int b = 0; b < TN; ++b) {
            const unsigned m = __ballot_sync(kFull, pass[b]) & hm;
            if (m == 0) continue;
            if (n + __popc(m) > CAP) {
              __syncwarp();
              merge_into<KCAP>(pq, k, lane < n ? wbuf[lane] : kNone);
              n = 0;
            }
            if ((m >> lane) & 1)
              wbuf[n + __popc(m & ((1u << lane) - 1))] =
                  make_key(d[a][b], n0 + tx + 16 * b);
            n += __popc(m);
          }
          if (n) {
            __syncwarp();
            merge_into<KCAP>(pq, k, lane < n ? wbuf[lane] : kNone);
          }
        }
      }
    }
    // the next tile's leading barrier orders the warps' buffers before
    // its ring
  }
  __syncthreads();
  for (int i = t; i < BQ * k; i += dense::kThreads) {
    const int r = i / k, j = i - r * k, qi = q0 + r;
    if (qi >= Q) continue;
    const long long o = (static_cast<long long>(qi) * splits + sp) * k + j;
    out_v[o] = key_value(pool[i]);
    out_p[o] = key_row(pool[i]);
  }
}

// one warp per query: merge its `splits` partial pools into the final k
template <int KCAP>
__global__ void __launch_bounds__(dense::kThreads) filtered_topk_merge(
    const float* __restrict__ part_v, const int* __restrict__ part_p,
    float* __restrict__ out_v, int* __restrict__ out_p, int Q, int N, int k,
    int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  long long* pool = reinterpret_cast<long long*>(smem) + warp * k;
  const int qi = blockIdx.x * (dense::kThreads / 32) + warp;
  if (qi >= Q) return;  // the whole warp
  for (int i = lane; i < k; i += 32) pool[i] = make_key(scan::inf(), N);
  __syncwarp();
  const int total = splits * k;
  const long long o = static_cast<long long>(qi) * total;
  LanePool lp;
  if constexpr (KCAP == 32) lp.load(pool, k);
  for (int base = 0; base < total; base += 32) {
    const int i = base + lane;
    long long c = kNone;
    if (i < total && part_v[o + i] < scan::inf())
      c = make_key(part_v[o + i], part_p[o + i]);
    if constexpr (KCAP == 32) {
      unsigned m = __ballot_sync(kFull, c < __shfl_sync(kFull, lp.e, k - 1));
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        lp.offer(__shfl_sync(kFull, c, src), k - 1);
      }
    } else {
      if (!(c < pool[k - 1])) c = kNone;
      if (__any_sync(kFull, c != kNone)) merge_into<KCAP>(pool, k, c);
    }
  }
  if constexpr (KCAP == 32) {
    lp.store(pool, k);
    __syncwarp();
  }
  for (int i = lane; i < k; i += 32) {
    out_v[static_cast<long long>(qi) * k + i] = key_value(pool[i]);
    out_p[static_cast<long long>(qi) * k + i] = key_row(pool[i]);
  }
}

// the instance of (Q, k): its query tile, as kernels/filtered_topk.py's
// query_tile mirrors it
int query_tile(int Q, int k) {
  if (Q <= 16) return 16;
  if (k > 32 || Q <= 64) return 32;
  return 128;
}

template <int BQ, int BN, int MINB, int KCAP, int FAULT>
cudaError_t launch_partial(bool l2, dim3 grid, cudaStream_t st,
                           const float* q, const float* x, const int* lq,
                           const int* lx, float* pv, int* pp, int Q, int N,
                           int D, int W, int k, int span, int splits) {
  using L = Layout<BQ, BN>;
  static bool opted_l2 = false, opted_ip = false;
  const cudaError_t err =
      l2 ? dense::allow_smem(
               filtered_topk_partial<BQ, BN, MINB, KCAP, true, FAULT>,
               L::bytes(KCAP), opted_l2)
         : dense::allow_smem(
               filtered_topk_partial<BQ, BN, MINB, KCAP, false, FAULT>,
               L::bytes(KCAP), opted_ip);
  if (err != cudaSuccess) return err;
  const bool vec = dense::vec_ok(q, x, D);
  const int bytes = L::bytes(k);
  if (l2)
    filtered_topk_partial<BQ, BN, MINB, KCAP, true, FAULT>
        <<<grid, dense::kThreads, bytes, st>>>(q, x, lq, lx, pv, pp, Q, N, D,
                                               W, k, span, splits, vec);
  else
    filtered_topk_partial<BQ, BN, MINB, KCAP, false, FAULT>
        <<<grid, dense::kThreads, bytes, st>>>(q, x, lq, lx, pv, pp, Q, N, D,
                                               W, k, span, splits, vec);
  return cudaGetLastError();
}

// the blocks an SM of (Q, k)'s instance, as the card reports them
template <int BQ, int BN, int MINB, int KCAP>
int blocks_per_sm(int k) {
  using L = Layout<BQ, BN>;
  static bool opted = false;
  auto kernel = filtered_topk_partial<BQ, BN, MINB, KCAP, true, 0>;
  if (dense::allow_smem(kernel, L::bytes(KCAP), opted) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, dense::kThreads, L::bytes(k)) != cudaSuccess)
    return -1;
  return blocks;
}

template <int FAULT>
int run(const float* q, const float* x, const int* lq, const int* lx,
        float* part_v, int* part_p, float* out_v, int* out_p, int Q, int N,
        int D, int W, int k, int span, int splits, int metric_ip,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool l2 = metric_ip == 0;
  float* pv = splits > 1 ? part_v : out_v;
  int* pp = splits > 1 ? part_p : out_p;
  const int bq = query_tile(Q, k);
  const dim3 grid((Q + bq - 1) / bq, splits);
  cudaError_t err;
  if constexpr (FAULT != 0) {  // planted in the main instance only
    if (bq != 128) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_partial<128, 64, 3, 32, FAULT>(l2, grid, st, q, x, lq, lx,
                                                pv, pp, Q, N, D, W, k, span,
                                                splits);
  } else if (k <= 32) {
    err = bq == 16
              ? launch_partial<16, 128, 3, 32, 0>(l2, grid, st, q, x, lq, lx,
                                                  pv, pp, Q, N, D, W, k, span,
                                                  splits)
          : bq == 32
              ? launch_partial<32, 128, 3, 32, 0>(l2, grid, st, q, x, lq, lx,
                                                  pv, pp, Q, N, D, W, k, span,
                                                  splits)
              : launch_partial<128, 64, 3, 32, 0>(l2, grid, st, q, x, lq, lx,
                                                  pv, pp, Q, N, D, W, k, span,
                                                  splits);
  } else {
    err = bq == 16
              ? launch_partial<16, 128, 3, 256, 0>(l2, grid, st, q, x, lq, lx,
                                                   pv, pp, Q, N, D, W, k,
                                                   span, splits)
              : launch_partial<32, 128, 3, 256, 0>(l2, grid, st, q, x, lq, lx,
                                                   pv, pp, Q, N, D, W, k,
                                                   span, splits);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int per_block = dense::kThreads / 32;
  const int grid_m = (Q + per_block - 1) / per_block;
  const int bytes = per_block * k * static_cast<int>(sizeof(long long));
  if (k <= 32)
    filtered_topk_merge<32><<<grid_m, dense::kThreads, bytes, st>>>(
        part_v, part_p, out_v, out_p, Q, N, k, splits);
  else
    filtered_topk_merge<256><<<grid_m, dense::kThreads, bytes, st>>>(
        part_v, part_p, out_v, out_p, Q, N, k, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [Q, D] f32, x [N, D] f32, lq [Q, W] i32, lx [N, W] i32 -> out_v [Q, k]
// f32, out_p [Q, k] i32 (Q, N ≥ 1, 1 ≤ k ≤ 256; span a multiple of 128,
// splits = ⌈N / span⌉ ≤ 65,535).  With splits > 1, part_v/part_p
// [Q, splits, k] are the per-span scratch.  Returns cudaGetLastError().
extern "C" int filtered_topk(const float* q, const float* x, const int* lq,
                             const int* lx, float* part_v, int* part_p,
                             float* out_v, int* out_p, int Q, int N, int D,
                             int W, int k, int span, int splits,
                             int metric_ip, void* stream) {
  return run<0>(q, x, lq, lx, part_v, part_p, out_v, out_p, Q, N, D, W, k,
                span, splits, metric_ip, stream);
}

// filtered_topk with planted fault 1 or 2 compiled in (the checks only;
// the 128 × 64 instance: Q > 64, k ≤ 32)
extern "C" int filtered_topk_planted(const float* q, const float* x,
                                     const int* lq, const int* lx,
                                     float* part_v, int* part_p, float* out_v,
                                     int* out_p, int Q, int N, int D, int W,
                                     int k, int span, int splits,
                                     int metric_ip, void* stream, int fault) {
  if (fault == 1)
    return run<1>(q, x, lq, lx, part_v, part_p, out_v, out_p, Q, N, D, W, k,
                  span, splits, metric_ip, stream);
  if (fault == 2)
    return run<2>(q, x, lq, lx, part_v, part_p, out_v, out_p, Q, N, D, W, k,
                  span, splits, metric_ip, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory of a block of (Q, k)'s instance
extern "C" int filtered_topk_smem_bytes(int Q, int k) {
  const int bq = query_tile(Q, k);
  return bq == 16    ? Layout<16, 128>::bytes(k)
         : bq == 32 ? Layout<32, 128>::bytes(k)
                    : Layout<128, 64>::bytes(k);
}

// blocks of (Q, k)'s instance an SM holds (l2), from the occupancy API;
// -1 on an error
extern "C" int filtered_topk_blocks_per_sm(int Q, int k) {
  const int bq = query_tile(Q, k);
  if (k <= 32)
    return bq == 16   ? blocks_per_sm<16, 128, 3, 32>(k)
           : bq == 32 ? blocks_per_sm<32, 128, 3, 32>(k)
                      : blocks_per_sm<128, 64, 3, 32>(k);
  return bq == 16 ? blocks_per_sm<16, 128, 3, 256>(k)
                  : blocks_per_sm<32, 128, 3, 256>(k);
}
