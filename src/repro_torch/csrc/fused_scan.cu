// Fused segmented arena scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/fused_scan.py::_pallas_fused_scan.  For every
// query q and every segment position pos < min(len[q], lmax):
//
//   gid  = rows_concat[clip(start[q] + pos, 0, R - 1)]
//   keep = lq[q] ⊆ alw[gid]  and  (no tombstones or gid alive)
//   d    = -ip                      (ip)
//        = (‖q‖² − 2·ip) + axn[gid]   (l2, the norms form)
//
// with ip = sum_e q_e · dequant(ax[gid, e]) accumulated in order (see
// scan_common.cuh), and returns the k' smallest (d, pos) pairs of the kept
// candidates in (value, position) order; slots past the last kept
// candidate are (+inf, lmax).  This is the semantics of the oracle
// (_lax_fused_scan and ref.segmented_filtered_topk).  The Pallas kernel
// instead clamps its id-window copy to the end of the row table and
// mislabels the lanes of a segment whose chunk window runs past it; the
// port follows the oracle.
//
// Bound on the card.  Per (query, row) pair the scan reads the 4-byte row
// id, W label words and — when the labels pass — one scattered storage row
// (D x 4/2/1 bytes), its norm and, for int8, its scale and zero, for ~2·D
// flops: far under the ridge point, so this kernel's own traffic is bytes.
// Counted as the function needs it (each input read once), a tier whose
// queries share one segment — the top tier of the main path — is bound by
// operations instead: its rows could be read once for all its queries,
// which this kernel does not do (each block reads its query's rows).
// Design:
//   * one block of 256 threads per (query, span split); each thread owns
//     one position per 256-wide tile and gathers its row itself, so no
//     [Q, span] distance matrix ever reaches device memory;
//   * the running top-k' lives in shared memory as a sorted pool.  A tile
//     offers only candidates that beat the pool's k'-th key (after the
//     first tiles almost none do), and an admitted batch is merged by
//     rank: every key is unique (positions are), so each element's rank
//     in the union is its slot and the merge needs no sort;
//   * the span of a large tier is split across blocks (the tile model in
//     launch/roofline.py picks the split), so a 2^20-row segment keeps
//     the whole card busy.  Each split keeps its own k' best, and a second
//     small kernel merges the splits per query.  The (value, position)
//     order is total, so the result does not depend on the split.
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;

using scan::key_less;

// The block's running top-k': pool_v/pool_p hold two sorted buffers of
// kp keys each (double-buffered across merges), cand_v/cand_p one tile's
// admitted candidates.
struct Pool {
  float* pool_v;
  int* pool_p;
  float* cand_v;
  int* cand_p;
  int* n_cand;  // shared counter, 0 between offers
  int kp;
  int cnt;  // block-uniform: keys held
  int cur;  // block-uniform: live buffer

  __device__ float v(int i) const { return pool_v[cur * kp + i]; }
  __device__ int p(int i) const { return pool_p[cur * kp + i]; }

  // Offer this thread's candidate (has == false: none).  Every thread of
  // the block must call it: it synchronizes.
  __device__ void offer(bool has, float d, int pos) {
    __syncthreads();
    const bool admit =
        has && d < scan::inf() &&
        (cnt < kp || key_less(d, pos, v(kp - 1), p(kp - 1)));
    if (admit) {
      const int slot = atomicAdd(n_cand, 1);
      cand_v[slot] = d;
      cand_p[slot] = pos;
    }
    __syncthreads();
    const int nc = *n_cand;
    if (nc == 0) return;
    const int m = cnt + nc;
    const int nxt = cur ^ 1;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      float vi;
      int pi, rank;
      if (i < cnt) {
        vi = v(i);
        pi = p(i);
        rank = i;
      } else {
        vi = cand_v[i - cnt];
        pi = cand_p[i - cnt];
        int lo = 0, hi = cnt;  // pool keys below (vi, pi)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (key_less(v(mid), p(mid), vi, pi))
            lo = mid + 1;
          else
            hi = mid;
        }
        rank = lo;
      }
      for (int j = 0; j < nc; ++j) rank += key_less(cand_v[j], cand_p[j], vi, pi);
      if (rank < kp) {
        pool_v[nxt * kp + rank] = vi;
        pool_p[nxt * kp + rank] = pi;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) *n_cand = 0;
    cnt = min(kp, m);
    cur = nxt;
  }

  __device__ void emit(float* out_v, int* out_p, int lmax) const {
    for (int j = threadIdx.x; j < kp; j += blockDim.x) {
      out_v[j] = j < cnt ? v(j) : scan::inf();
      out_p[j] = j < cnt ? p(j) : lmax;
    }
  }
};

// shared layout after `head` floats: pool_v[2kp] pool_p[2kp] cand_v[T] cand_p[T]
__device__ Pool make_pool(float* base, int kp, int* n_cand) {
  Pool P;
  P.pool_v = base;
  P.pool_p = reinterpret_cast<int*>(P.pool_v + 2 * kp);
  P.cand_v = reinterpret_cast<float*>(P.pool_p + 2 * kp);
  P.cand_p = reinterpret_cast<int*>(P.cand_v + kThreads);
  P.n_cand = n_cand;
  P.kp = kp;
  P.cnt = 0;
  P.cur = 0;
  return P;
}

__device__ __forceinline__ int seg_len(const int* lens, int qi, int lmax) {
  return max(0, min(lens[qi], lmax));
}

template <int DT, bool L2, bool TOMB>
__global__ void __launch_bounds__(kThreads) fused_scan_partial(
    const float* __restrict__ q, const int* __restrict__ lq,
    const void* __restrict__ ax, const int* __restrict__ alw,
    const float* __restrict__ axn, const int* __restrict__ rc, int R,
    const int* __restrict__ starts, const int* __restrict__ lens,
    const uint8_t* __restrict__ tomb, const float* __restrict__ scales,
    const float* __restrict__ zeros, float* __restrict__ out_v,
    int* __restrict__ out_p, int D, int W, int lmax, int kp, int span,
    int splits, bool vec) {
  extern __shared__ float smem[];
  __shared__ int s_lq[kMaxWords];
  __shared__ float s_qn;
  __shared__ int s_n;
  const int qi = blockIdx.y;
  const int sp = blockIdx.x;
  const int lo = sp * span;
  const int hi = min(lo + span, seg_len(lens, qi, lmax));
  // splits past the segment's end are never read by the merge
  if (lo >= hi && splits > 1) return;

  float* qs = smem;  // [D]
  Pool P = make_pool(smem + D, kp, &s_n);
  for (int e = threadIdx.x; e < D; e += kThreads)
    qs[e] = q[static_cast<long long>(qi) * D + e];
  if (threadIdx.x < W) s_lq[threadIdx.x] = lq[qi * W + threadIdx.x];
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;  // ‖q‖², in order
    for (int e = 0; e < D; ++e) acc = __fadd_rn(acc, __fmul_rn(qs[e], qs[e]));
    s_qn = acc;
  }
  __syncthreads();
  const float qn = s_qn;
  const long long start = starts[qi];

  for (int base = lo; base < hi; base += kThreads) {
    const int pos = base + threadIdx.x;
    bool has = false;
    float d = 0.0f;
    if (pos < hi) {
      long long p = start + pos;
      p = p < 0 ? 0 : (p > R - 1 ? R - 1 : p);
      const long long gid = rc[p];
      if (scan::contains(s_lq, alw + gid * W, W) &&
          (!TOMB || scan::alive(tomb, gid))) {
        const float s = DT == scan::U8 ? scales[gid] : 0.0f;
        const float z = DT == scan::U8 ? zeros[gid] : 0.0f;
        const float ip = scan::row_sum<DT, false>(
            qs, scan::row_ptr(ax, DT, gid, D), D, vec, s, z);
        d = L2 ? scan::l2_norms_form(qn, ip, axn[gid]) : -ip;
        has = true;
      }
    }
    P.offer(has, d, pos);
  }
  __syncthreads();
  const long long o = (static_cast<long long>(qi) * splits + sp) * kp;
  P.emit(out_v + o, out_p + o, lmax);
}

// one block per query: merge the used splits' k' best into the final k'
__global__ void __launch_bounds__(kThreads) fused_scan_merge(
    const float* __restrict__ part_v, const int* __restrict__ part_p,
    const int* __restrict__ lens, float* __restrict__ out_v,
    int* __restrict__ out_p, int lmax, int kp, int span, int splits) {
  extern __shared__ float smem[];
  __shared__ int s_n;
  const int qi = blockIdx.x;
  Pool P = make_pool(smem, kp, &s_n);
  if (threadIdx.x == 0) s_n = 0;
  const int used = (seg_len(lens, qi, lmax) + span - 1) / span;
  const int total = used * kp;
  const long long o = static_cast<long long>(qi) * splits * kp;
  for (int base = 0; base < total; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool has = i < total;
    P.offer(has, has ? part_v[o + i] : 0.0f, has ? part_p[o + i] : 0);
  }
  __syncthreads();
  P.emit(out_v + static_cast<long long>(qi) * kp,
         out_p + static_cast<long long>(qi) * kp, lmax);
}

template <int DT, bool L2, bool TOMB>
void launch_partial(dim3 grid, size_t smem, cudaStream_t st, const float* q,
                    const int* lq, const void* ax, const int* alw,
                    const float* axn, const int* rc, int R,
                    const int* starts, const int* lens, const uint8_t* tomb,
                    const float* scales, const float* zeros, float* out_v,
                    int* out_p, int D, int W, int lmax, int kp, int span,
                    int splits, bool vec) {
  fused_scan_partial<DT, L2, TOMB><<<grid, kThreads, smem, st>>>(
      q, lq, ax, alw, axn, rc, R, starts, lens, tomb, scales, zeros, out_v,
      out_p, D, W, lmax, kp, span, splits, vec);
}

template <int DT>
void dispatch_partial(bool l2, bool tomb_on, dim3 grid, size_t smem,
                      cudaStream_t st, const float* q, const int* lq,
                      const void* ax, const int* alw, const float* axn,
                      const int* rc, int R, const int* starts,
                      const int* lens, const uint8_t* tomb,
                      const float* scales, const float* zeros, float* out_v,
                      int* out_p, int D, int W, int lmax, int kp, int span,
                      int splits, bool vec) {
#define FUSED_PARTIAL(L2, TB)                                                \
  launch_partial<DT, L2, TB>(grid, smem, st, q, lq, ax, alw, axn, rc, R,     \
                             starts, lens, tomb, scales, zeros, out_v, out_p, \
                             D, W, lmax, kp, span, splits, vec)
  if (l2 && tomb_on)
    FUSED_PARTIAL(true, true);
  else if (l2)
    FUSED_PARTIAL(true, false);
  else if (tomb_on)
    FUSED_PARTIAL(false, true);
  else
    FUSED_PARTIAL(false, false);
#undef FUSED_PARTIAL
}

}  // namespace

// q [Q, D] f32, lq [Q, W] i32, ax [N, D] (dtype 0 f32 / 1 f16 / 2 u8),
// alw [N, W] i32, axn [N] f32, rc [R] i32, starts/lens [Q] i32, tomb
// [⌈N/8⌉] u8 or null, scales/zeros [N] f32 (u8 only) -> out_v [Q, kp] f32,
// out_p [Q, kp] i32.  With splits > 1, part_v/part_p [Q, splits, kp] are
// the per-split scratch.  Returns cudaGetLastError().
extern "C" int fused_scan(const float* q, const int* lq, const void* ax,
                          const int* alw, const float* axn, const int* rc,
                          int R, const int* starts, const int* lens,
                          const uint8_t* tomb, const float* scales,
                          const float* zeros, float* part_v, int* part_p,
                          float* out_v, int* out_p, int Q, int D, int W,
                          int lmax, int kp, int span, int splits, int dtype,
                          int metric_ip, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t pool_bytes =
      static_cast<size_t>(4 * kp + 2 * kThreads) * sizeof(float);
  const size_t smem = static_cast<size_t>(D) * sizeof(float) + pool_bytes;
  const dim3 grid(splits, Q);
  float* pv = splits > 1 ? part_v : out_v;
  int* pp = splits > 1 ? part_p : out_p;
  const bool l2 = metric_ip == 0;
  const bool tomb_on = tomb != nullptr;
  const bool v = vec != 0;
  if (dtype == scan::F32)
    dispatch_partial<scan::F32>(l2, tomb_on, grid, smem, st, q, lq, ax, alw,
                                axn, rc, R, starts, lens, tomb, scales, zeros,
                                pv, pp, D, W, lmax, kp, span, splits, v);
  else if (dtype == scan::F16)
    dispatch_partial<scan::F16>(l2, tomb_on, grid, smem, st, q, lq, ax, alw,
                                axn, rc, R, starts, lens, tomb, scales, zeros,
                                pv, pp, D, W, lmax, kp, span, splits, v);
  else
    dispatch_partial<scan::U8>(l2, tomb_on, grid, smem, st, q, lq, ax, alw,
                               axn, rc, R, starts, lens, tomb, scales, zeros,
                               pv, pp, D, W, lmax, kp, span, splits, v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  fused_scan_merge<<<Q, kThreads, pool_bytes, st>>>(
      part_v, part_p, lens, out_v, out_p, lmax, kp, span, splits);
  return static_cast<int>(cudaGetLastError());
}
