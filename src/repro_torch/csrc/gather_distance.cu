// Segmented gather + fused filtered distance for Hopper (sm_90a).
//
// Replaces src/repro/kernels/gather_distance.py::
// segmented_gather_distance_pallas (the Pallas TPU kernel whose grid step
// DMAs one scalar-prefetched arena row per (query, candidate) pair).
//
// out[q, l] = dist(q, x[gids[q, l]])  if l < lens[q] and lq[q] ⊆ lxw[gid]
//           = +inf                    otherwise
// with dist the DIRECT form sum_e (q_e - x_e)^2 (l2) or -sum_e q_e x_e (ip),
// as the TPU kernel computes it, and int8 codes dequantized in-register.
//
// Arithmetic contract.  Every value is summed in order over D with a
// rounded subtract, multiply and add (l2: t = q − x, acc = acc + t·t; ip:
// scan::mac), never an FMA, with int8 codes dequantized exactly as
// scan::dequant does.  The two schedules below run the same operations in
// the same order on every pair, so they agree bitwise on every input and
// dtype: a looped query (a run of one) and a batched one give the same
// bits, which the unfused engines' batched == looped rests on.
//
// Bound on the card.  Each live pair reads one scattered storage row
// (D x 4/2/1 bytes), its W label words and, for int8, its scale and zero,
// for ~3·D flops: far under the ridge point, so alone a pair's traffic is
// bytes.  Where many queries list the same rows — the unfused executor's
// tiers, whose queries arrive sorted by segment start, so the queries of
// one segment sit side by side and list the same rows; at the top tier
// 245 queries list the same 16,384 rows a chunk — each row read once
// leaves the operations (3 rounded operations a feature a pair) to bound
// it.
//
// Design: two schedules.
//   * seg_gather_kernel (max_qtile = 1; lists that differ per query, such
//     as the +rerank shortlists; int8 rows; launches whose tile grid would
//     not fill the card): one thread per (query, candidate) pair,
//     the query row staged once per block in shared memory, 16-byte row
//     loads, and no row read at all for pairs that fail the length or
//     label test.  Rows are scattered, so a warp's loads are not coalesced
//     across threads; each thread's own row is read in full 32-byte
//     sectors.
//   * seg_gather_tile_kernel (f32 and f16 rows): one block of 256 threads
//     owns up to kTQ = 64 consecutive queries and a kBN = 128-column
//     window of gids.  It loads
//     the queries' lens and label words, compares each query's window with
//     the one before (a warp a query, coalesced) and splits the tile into
//     runs of consecutive queries with equal windows.  A run of more than
//     kMinRun = 8 queries gathers each listed row once (the columns below
//     the run's longest length): the rows' ids and label words into
//     shared memory, then the rows as stored and the run's queries,
//     kKC = 32 features a step, by 16-byte cp.async one step ahead of the
//     math (f16 rows widened once per element in shared memory).  Thread (ty, tx) holds queries ty + 16·a against columns
//     tx + 16·b in registers (4 × 8), reading 4 features of each with one
//     16-byte shared load; the length and label tests run in the epilogue.
//     Queries of shorter runs take the per-pair code above, inside the
//     same block, where the queries of a short run share the rows they
//     read through L1.  The tile needs 16-byte aligned rows and queries
//     (D % 16 == 0); the wrapper takes the per-pair kernel otherwise, and
//     also where the tile grid would hold fewer blocks than the card runs
//     at once (two an SM: the per-pair code inside a block then leaves
//     SMs idle) and for int8 rows (a pair reads 136 bytes and a failing
//     pair none, where the tile computes every pair of its run; slower at
//     every launch of an int8 unfused batch, PERF.md §6).
//
// Also replaces src/repro/kernels/gather_distance.py::gather_distance_pallas
// (one grid step per scattered candidate row, its id scalar-prefetched):
//
// out[q, b] = dist(q, x[ids[q, b]])  if ids[q, b] >= 0
//           = +inf                   otherwise
//
// the graph backend's per-hop neighbour distances, a batch of queries
// with an id list each ([Q, B]; the TPU kernel is the Q = 1 case), in the
// same DIRECT form.  Bound on the card: each live pair reads one scattered
// row (4·D bytes) for 3·D flops, so bytes.  Design: one thread per (query,
// id) pair over a flat grid (B is the graph degree, 16, so a block spans
// many queries); the query row is read through the L1 cache, the
// candidate row with 16-byte loads, and a pair with a negative id reads
// nothing.
#include <cuda_runtime.h>

#include "dense_tile.cuh"
#include "scan_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int DT, bool IP>
__global__ void __launch_bounds__(kThreads) seg_gather_kernel(
    const float* __restrict__ q, const int* __restrict__ lq,
    const void* __restrict__ x, const int* __restrict__ lxw,
    const int* __restrict__ gids, const int* __restrict__ lens,
    const float* __restrict__ scales, const float* __restrict__ zeros,
    float* __restrict__ out, int L, int D, int W, bool vec) {
  extern __shared__ float qs[];  // [D] this block's query row
  const int qi = blockIdx.y;
  for (int e = threadIdx.x; e < D; e += kThreads)
    qs[e] = q[static_cast<long long>(qi) * D + e];
  __syncthreads();
  const int li = blockIdx.x * kThreads + threadIdx.x;
  if (li >= L) return;
  const long long o = static_cast<long long>(qi) * L + li;
  float d = scan::inf();
  if (li < lens[qi]) {
    const long long gid = gids[o];
    if (scan::contains(lq + static_cast<long long>(qi) * W, lxw + gid * W,
                       W)) {
      const float s = DT == scan::U8 ? scales[gid] : 0.0f;
      const float z = DT == scan::U8 ? zeros[gid] : 0.0f;
      const void* row = scan::row_ptr(x, DT, gid, D);
      d = IP ? -scan::row_sum<DT, false>(qs, row, D, vec, s, z)
             : scan::row_sum<DT, true>(qs, row, D, vec, s, z);
    }
  }
  out[o] = d;
}

template <int DT, bool IP>
void launch(dim3 grid, size_t smem, cudaStream_t st, const float* q,
            const int* lq, const void* x, const int* lxw, const int* gids,
            const int* lens, const float* scales, const float* zeros,
            float* out, int L, int D, int W, bool vec) {
  seg_gather_kernel<DT, IP><<<grid, kThreads, smem, st>>>(
      q, lq, x, lxw, gids, lens, scales, zeros, out, L, D, W, vec);
}

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    const int* __restrict__ ids, float* __restrict__ out, long long pairs,
    int B, int D, bool vec, bool ip) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= pairs) return;
  const int id = ids[p];
  float d = scan::inf();
  if (id >= 0) {
    const float* qr = q + (p / B) * static_cast<long long>(D);
    const void* row = scan::row_ptr(x, scan::F32, id, D);
    d = ip ? -scan::row_sum<scan::F32, false>(qr, row, D, vec, 0.0f, 0.0f)
           : scan::row_sum<scan::F32, true>(qr, row, D, vec, 0.0f, 0.0f);
  }
  out[p] = d;
}


// ---------------------------------------------------------------------------
// the tile schedule
// ---------------------------------------------------------------------------

namespace gtile {

constexpr int kTQ = 64;       // queries of a block, at most
constexpr int kBN = 128;      // gids columns of a block
constexpr int kKC = 32;       // features per step
constexpr int kLD = kKC + 4;  // staged f32 pitch (floats): no bank conflicts
constexpr int kRQ = kTQ / 16;  // queries a thread: ty + 16·a
constexpr int kRN = kBN / 16;  // columns a thread: tx + 16·b
constexpr int kMaxWords = 8;
constexpr int WP = kMaxWords + 1;  // label-word pitch
// runs of more than this many queries are tiled; shorter ones take the
// per-pair code inside the block (the wrapper's TILE_MIN_RUN mirrors it)
constexpr int kMinRun = 8;

// Shared memory of a block, in bytes: two steps of rows as stored and of
// the run's queries, the widened f16 rows, the run's row ids and label
// words, then the tile's lens, label words and run table.  The wrapper's
// tile_smem_bytes mirrors it.
template <int DT>
struct Layout {
  static_assert(DT == scan::F32 || DT == scan::F16, "f32 or f16 rows");
  static constexpr int ES = DT == scan::F32 ? 4 : 2;
  static constexpr int CPR = kKC * ES / 16;  // 16-byte copies a row, step
  static constexpr int RP = kKC * ES + 16;   // row pitch (bytes)
  static constexpr int XS = 0;                         // [2][kBN][RP]
  static constexpr int QS = XS + 2 * kBN * RP;         // [2][kTQ][kLD] f32
  static constexpr int XF = QS + 2 * kTQ * kLD * 4;    // [kBN][kLD] f32
  static constexpr int GID = XF + (DT == scan::F32 ? 0 : kBN * kLD * 4);
  static constexpr int LXW = GID + kBN * 4;            // [kBN][WP] i32
  static constexpr int LEN = LXW + kBN * WP * 4;       // [kTQ] i32
  static constexpr int LQ = LEN + kTQ * 4;             // [kTQ][WP] i32
  static constexpr int SAME = LQ + kTQ * WP * 4;       // [kTQ] i32
  static constexpr int TILED = SAME + kTQ * 4;         // [kTQ] i32
  static constexpr int RUNS = TILED + kTQ * 4;  // begin, count, cols [kTQ]
  static constexpr int BYTES = RUNS + (3 * kTQ + 1) * 4;
};

struct Args {
  const float* q;
  const int* lq;
  const void* x;
  const int* lxw;
  const int* gids;
  const int* lens;
  float* out;
  int Q, L, D, W;
};

// One run of rq (> kMinRun) queries j0 .. j0 + rq − 1 of the block's tile,
// whose windows list the same rows: columns [0, cols) of the window are
// gathered once and computed for all of them.  Every thread of the block
// must call it.
template <int DT, bool IP>
__device__ void scan_run(const Args& a, unsigned char* smem, int q0, int c0,
                         int ncol, int j0, int rq, int cols) {
  using Ly = Layout<DT>;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  int* gid_s = reinterpret_cast<int*>(smem + Ly::GID);
  int(*lxw_s)[WP] = reinterpret_cast<int(*)[WP]>(smem + Ly::LXW);
  const int* len_s = reinterpret_cast<const int*>(smem + Ly::LEN);
  const int(*lq_s)[WP] = reinterpret_cast<const int(*)[WP]>(smem + Ly::LQ);
  float* xf = reinterpret_cast<float*>(smem + Ly::XF);
  auto xs = [&](int buf) { return smem + Ly::XS + buf * kBN * Ly::RP; };
  auto qs = [&](int buf) {
    return reinterpret_cast<float*>(smem + Ly::QS) + buf * kTQ * kLD;
  };
  const int na = (rq + 15) / 16;  // query groups a thread computes
  const long long qf = q0 + j0;   // the run's first query

  __syncthreads();  // the block's previous user of the buffers is done
  if (t < kBN) {
    const bool ok = t < cols;
    const long long gid = ok ? a.gids[qf * a.L + c0 + t] : 0;
    gid_s[t] = static_cast<int>(gid);
    for (int w = 0; w < a.W; ++w) lxw_s[t][w] = ok ? a.lxw[gid * a.W + w] : 0;
  }
  __syncthreads();

  // step s's rows (as stored) and queries into buffer s & 1; columns past
  // the run's longest length, features past D and query rows past the run
  // are zero-filled, not read
  auto issue = [&](int s) {
    const int e0 = s * kKC;
    unsigned char* xb = xs(s & 1);
    for (int i = t; i < kBN * Ly::CPR; i += kThreads) {
      const int c = i / Ly::CPR, k = i % Ly::CPR;
      const bool ok = c < cols && e0 * Ly::ES + 16 * k < a.D * Ly::ES;
      const char* src =
          static_cast<const char*>(scan::row_ptr(a.x, DT, gid_s[c], a.D)) +
          e0 * Ly::ES + 16 * k;
      dense::cp_async16(xb + c * Ly::RP + 16 * k,
                        ok ? static_cast<const void*>(src) : a.x, ok);
    }
    float* qb = qs(s & 1);
    for (int i = t; i < 16 * na * (kKC / 4); i += kThreads) {
      const int j = i / (kKC / 4), k = i % (kKC / 4);
      const bool ok = j < rq && e0 + 4 * k < a.D;
      dense::cp_async16(qb + j * kLD + 4 * k,
                        ok ? a.q + (qf + j) * a.D + e0 + 4 * k : a.q, ok);
    }
  };

  float acc[kRQ][kRN];
#pragma unroll
  for (int i = 0; i < kRQ; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.0f;

  const int steps = (a.D + kKC - 1) / kKC;
  issue(0);
  dense::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    dense::cp_async_wait<0>();
    __syncthreads();  // step s is in; step s − 1's readers are done
    if (s + 1 < steps) issue(s + 1);  // in flight during the math
    dense::cp_async_commit();
    const unsigned char* xb = xs(s & 1);
    if (DT == scan::F16) {  // widened once per element
      for (int i = t; i < kBN * kKC; i += kThreads) {
        const int c = i / kKC, e = i % kKC;
        xf[c * kLD + e] = __half2float(
            reinterpret_cast<const __half*>(xb + c * Ly::RP)[e]);
      }
      __syncthreads();
    }
    const float* xr =
        DT == scan::F16 ? xf : reinterpret_cast<const float*>(xb);
    const float* qb = qs(s & 1);
    const int kc = min(kKC, a.D - s * kKC);  // a multiple of 16
    for (int e = 0; e < kc; e += 4) {
      float4 qa[kRQ];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
        if (i < na)
          qa[i] = *reinterpret_cast<const float4*>(qb + (ty + 16 * i) * kLD +
                                                   e);
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xr + (tx + 16 * j) * kLD + e);
        // feature by feature, in order: the per-pair path's operations
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int i = 0; i < kRQ; ++i) {
            if (i >= na) continue;
            const float qe = dense::part(qa[i], f), xe = dense::part(xv, f);
            if (IP) {
              acc[i][j] = scan::mac(acc[i][j], xe, qe);
            } else {
              const float d = __fsub_rn(qe, xe);
              acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(d, d));
            }
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int j = ty + 16 * i;
    if (i >= na || j >= rq) continue;
    const int len = len_s[j0 + j];
    float* o = a.out + (qf + j) * a.L + c0;
#pragma unroll
    for (int jj = 0; jj < kRN; ++jj) {
      const int c = tx + 16 * jj;
      if (c >= ncol) continue;
      bool keep = c0 + c < len;
      for (int w = 0; w < a.W; ++w)
        keep = keep && ((lq_s[j0 + j][w] & lxw_s[c][w]) == lq_s[j0 + j][w]);
      o[c] = keep ? (IP ? -acc[i][jj] : acc[i][jj]) : scan::inf();
    }
  }
}

template <int DT, bool IP>
__global__ void __launch_bounds__(kThreads, 2) seg_gather_tile_kernel(
    Args a, int qt) {
  using Ly = Layout<DT>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* len_s = reinterpret_cast<int*>(smem + Ly::LEN);
  int(*lq_s)[WP] = reinterpret_cast<int(*)[WP]>(smem + Ly::LQ);
  int* same = reinterpret_cast<int*>(smem + Ly::SAME);
  int* tiled = reinterpret_cast<int*>(smem + Ly::TILED);
  int* run_begin = reinterpret_cast<int*>(smem + Ly::RUNS);
  int* run_count = run_begin + kTQ;
  int* run_cols = run_count + kTQ;
  int* n_runs = run_cols + kTQ;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int q0 = blockIdx.x * qt, c0 = blockIdx.y * kBN;
  const int nq = min(qt, a.Q - q0), ncol = min(kBN, a.L - c0);

  for (int j = t; j < nq; j += kThreads) len_s[j] = a.lens[q0 + j];
  for (int i = t; i < nq * a.W; i += kThreads)
    lq_s[i / a.W][i % a.W] =
        a.lq[static_cast<long long>(q0 + i / a.W) * a.W + i % a.W];
  __syncthreads();
  // same[j]: query j's window equals query j − 1's, and both have a
  // column below their length in it
  for (int j = warp; j < nq; j += kThreads / 32) {
    bool eq = j > 0 && len_s[j] > c0 && len_s[j - 1] > c0;  // warp-uniform
    if (eq) {
      const int* g = a.gids + static_cast<long long>(q0 + j) * a.L + c0;
      bool diff = false;
      for (int c = lane; c < ncol; c += 32) diff = diff || g[c] != g[c - a.L];
      eq = !__any_sync(0xffffffffu, diff);
    }
    if (lane == 0) same[j] = eq;
  }
  __syncthreads();
  if (t == 0) {  // the tile's runs, in order; a run of > kMinRun is tiled
    int n = 0;
    for (int j = 0; j < nq;) {
      int e = j + 1;
      while (e < nq && same[e]) ++e;
      const bool tile = e - j > kMinRun;
      int cols = 0;
      for (int i = j; i < e; ++i) {
        tiled[i] = tile;
        cols = max(cols, min(len_s[i] - c0, ncol));
      }
      if (tile) {
        run_begin[n] = j;
        run_count[n] = e - j;
        run_cols[n] = cols;
        ++n;
      }
      j = e;
    }
    *n_runs = n;
  }
  __syncthreads();
  const int runs = *n_runs;
  for (int r = 0; r < runs; ++r)
    scan_run<DT, IP>(a, smem, q0, c0, ncol, run_begin[r], run_count[r],
                     run_cols[r]);

  // the other queries: one thread per (query, column) pair, as
  // seg_gather_kernel computes it
  for (int i = t; i < nq * kBN; i += kThreads) {
    const int j = i / kBN, c = i % kBN;
    if (tiled[j] || c >= ncol) continue;
    const long long qi = q0 + j;
    const long long o = qi * a.L + c0 + c;
    float d = scan::inf();
    if (c0 + c < len_s[j]) {
      const long long gid = a.gids[o];
      if (scan::contains(lq_s[j], a.lxw + gid * a.W, a.W)) {
        const void* row = scan::row_ptr(a.x, DT, gid, a.D);
        const float* qr = a.q + qi * a.D;
        d = IP ? -scan::row_sum<DT, false>(qr, row, a.D, true, 0.0f, 0.0f)
               : scan::row_sum<DT, true>(qr, row, a.D, true, 0.0f, 0.0f);
      }
    }
    a.out[o] = d;
  }
}

template <int DT, bool IP>
cudaError_t launch_tile(dim3 grid, cudaStream_t st, const Args& a, int qt) {
  constexpr int bytes = Layout<DT>::BYTES;
  static bool opted = false;
  const cudaError_t err =
      dense::allow_smem(seg_gather_tile_kernel<DT, IP>, bytes, opted);
  if (err != cudaSuccess) return err;
  seg_gather_tile_kernel<DT, IP><<<grid, kThreads, bytes, st>>>(a, qt);
  return cudaGetLastError();
}

}  // namespace gtile

}  // namespace

// q [Q, D] f32, x [N, D] f32, ids [Q, B] i32 (< 0: padding) -> out [Q, B]
// f32.  Returns cudaGetLastError().
extern "C" int gather_distance(const float* q, const float* x, const int* ids,
                               float* out, int Q, int B, int D, int metric_ip,
                               int vec, void* stream) {
  const long long pairs = static_cast<long long>(Q) * B;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
  gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, x, ids, out, pairs, B, D, vec != 0, metric_ip != 0);
  return static_cast<int>(cudaGetLastError());
}

// q [Q, D] f32, lq [Q, W] i32, x [N, D] (dtype 0 f32 / 1 f16 / 2 u8),
// lxw [N, W] i32, gids [Q, L] i32, lens [Q] i32, scales/zeros [N] f32
// (u8 only, else null) -> out [Q, L] f32.  qtile > 1 takes the tile
// schedule with blocks of qtile queries (≤ 64) where the rows are f32 or
// f16 and the rows and queries allow 16-byte copies, runs of more than
// kMinRun queries tiled; else the per-pair kernel.  Returns
// cudaGetLastError().
extern "C" int seg_gather_distance(const float* q, const int* lq,
                                   const void* x, const int* lxw,
                                   const int* gids, const int* lens,
                                   const float* scales, const float* zeros,
                                   float* out, int Q, int L, int D, int W,
                                   int dtype, int metric_ip, int vec,
                                   int qtile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  const bool tile = qtile > 1 && dtype != scan::U8 && v && D % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (tile) {
    const gtile::Args a{q, lq, x, lxw, gids, lens, out, Q, L, D, W};
    const int qt = qtile < gtile::kTQ ? qtile : gtile::kTQ;
    const dim3 grid((Q + qt - 1) / qt, (L + gtile::kBN - 1) / gtile::kBN);
    cudaError_t err;
#define SEG_GATHER_TILE(DT)                                \
  err = metric_ip ? gtile::launch_tile<DT, true>(grid, st, a, qt) \
                  : gtile::launch_tile<DT, false>(grid, st, a, qt)
    if (dtype == scan::F32)
      SEG_GATHER_TILE(scan::F32);
    else
      SEG_GATHER_TILE(scan::F16);
#undef SEG_GATHER_TILE
    return static_cast<int>(err);
  }
  const dim3 grid((L + kThreads - 1) / kThreads, Q);
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
#define SEG_GATHER_LAUNCH(DT)                                               \
  (metric_ip ? launch<DT, true>(grid, smem, st, q, lq, x, lxw, gids, lens, \
                                scales, zeros, out, L, D, W, v)             \
             : launch<DT, false>(grid, smem, st, q, lq, x, lxw, gids,       \
                                 lens, scales, zeros, out, L, D, W, v))
  if (dtype == scan::F32)
    SEG_GATHER_LAUNCH(scan::F32);
  else if (dtype == scan::F16)
    SEG_GATHER_LAUNCH(scan::F16);
  else
    SEG_GATHER_LAUNCH(scan::U8);
#undef SEG_GATHER_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory of a tile-schedule block for f32 (0) or f16 (1)
// rows (the wrapper's tile_smem_bytes must agree)
extern "C" int seg_gather_smem_bytes(int dtype) {
  return dtype == scan::F32 ? gtile::Layout<scan::F32>::BYTES
                            : gtile::Layout<scan::F16>::BYTES;
}
