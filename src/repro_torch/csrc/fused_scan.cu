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
// flops.  Counted as the function needs it (each input read once), a tier
// whose queries share one segment — the top tier of the main path, where
// every query routes to the top index — is bound by operations: its rows
// are read once for all its queries.  A tier of queries alone in their
// segments is bound by bytes.
//
// Design.  A tier's queries arrive sorted by segment start, so queries
// that share a segment sit next to each other: a "run".
//   * fused_scan_tile: one block of 256 threads per (tile of up to 64
//     consecutive queries, span split).  The block finds its tile's runs
//     and takes them in turn.  A run of more than kNarrow queries reads
//     each tile of 128 candidate rows once for all its queries: the rows'
//     ids, then their label words, norms (and int8 scales and zeros), then
//     the rows as stored and the queries, 32 features a step, are copied
//     to shared memory with cp.async one step ahead of the math, so the
//     copies in flight hold no registers (f16 / int8 rows are widened in
//     shared memory).  Warp w holds the register tile of its queries
//     w + 8·i against rows lane + 32·j: a [64 × 128] distance tile on the
//     CUDA cores whose query values are broadcast loads.  Each query's
//     running top-k' (up to 64 keys, two per lane) is kept in shared
//     memory by the warp that owns the query and takes its warp's 128
//     candidates of a row tile 32 at a time, straight from registers: a
//     ballot against its k'-th key admits the few that beat it, each
//     inserted by rank.  A run of at most kNarrow queries scans one query
//     at a time as the per-query kernel does.  The tile needs 16-byte
//     aligned rows (D % 16 == 0) and k' ≤ 64; the wrapper takes the
//     per-query kernel otherwise.
//   * fused_scan_partial (the per-query kernel, a tile of one query): one
//     thread per position gathers its own row, and the running top-k'
//     lives in shared memory as a sorted pool that admits only candidates
//     beating its k'-th key, merged by rank (keys are unique: positions
//     are).
//   * the span of a large tier is split across blocks (the tile model in
//     launch/roofline.py picks the query tile and the split together).
//     Each split keeps its own k' best, and fused_scan_merge merges the
//     splits per query.
// Every value is a function of its (query, row) pair alone — each inner
// product summed in order over D with a rounded multiply and a rounded add
// (scan::mac), never an FMA — and the (value, position) order is total, so
// the result does not depend on the query tile, on which queries share a
// block, on the split or on the grid.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;
constexpr int kTQ = 64;       // queries of a tile-kernel block, at most
constexpr int kBN = 128;      // rows per tile of a shared run
constexpr int kKC = 32;       // features per step
constexpr int kLD = kKC + 4;  // staged row pitch (floats): no bank conflicts
constexpr int kNarrow = 4;    // runs up to this size scan query by query
constexpr unsigned kFull = 0xffffffffu;
// the register tile of a shared run: warp w holds queries w + 8·i
// (i < kRQ) against rows lane + 32·j (j < kRN)
constexpr int kRQ = kTQ / 8;
constexpr int kRN = kBN / 32;

constexpr int kMetaWords = kBN * (5 + kMaxWords);  // a tile's row metadata

// Shared memory of a run's tile scan, in bytes: two steps of rows as
// stored and of queries, the widened f16 / int8 rows, two buffers of row
// metadata, then each query's running top-k' (2·32·KPS keys and a count)
template <int DT, int KPS>
struct RunSmem {
  static constexpr int ES = DT == scan::F32 ? 4 : (DT == scan::F16 ? 2 : 1);
  static constexpr int CPR = kKC * ES / 16;   // 16-byte copies a row, step
  static constexpr int RP = kKC * ES + 16;    // row pitch: no conflicts
  static constexpr int XS = 0;                // [2][kBN][RP]
  static constexpr int QS = XS + 2 * kBN * RP;           // [2][kTQ][kLD] f32
  static constexpr int XF = QS + 2 * kTQ * kLD * 4;      // [kBN][kLD] f32
  static constexpr int META = XF + (DT == scan::F32 ? 0 : kBN * kLD * 4);
  static constexpr int POOL = META + 2 * kMetaWords * 4;
  static constexpr int POOL_WORDS = 2 * 32 * KPS + 1;
  static constexpr int BYTES = POOL + kTQ * POOL_WORDS * 4;
};

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

// One query's running top-k' (k' ≤ 32·KPS) held across a warp: lane l
// keeps slots l and 32 + l of the (value, position) keys in ascending
// order; cnt (warp-uniform) slots are used.
template <int KPS>
struct WarpPool {
  float v[KPS];
  int p[KPS];
  int cnt;

  __device__ void init(int sentinel) {
#pragma unroll
    for (int s = 0; s < KPS; ++s) {
      v[s] = scan::inf();
      p[s] = sentinel;
    }
    cnt = 0;
  }

  // the k-th key (slot k − 1; k warp-uniform)
  __device__ void kth(int k, float& tv, int& tp) const {
    if (KPS == 1 || k <= 32) {
      tv = __shfl_sync(kFull, v[0], k - 1);
      tp = __shfl_sync(kFull, p[0], k - 1);
    } else {
      tv = __shfl_sync(kFull, v[KPS - 1], k - 33);
      tp = __shfl_sync(kFull, p[KPS - 1], k - 33);
    }
  }

  // Every lane offers one (value, position); +inf offers nothing.  All 32
  // lanes of the warp must call it.
  __device__ void offer(float cv, int cp, int k) {
    const int lane = threadIdx.x & 31;
    float tv;
    int tp;
    kth(k, tv, tp);
    const bool want =
        cv < scan::inf() && (cnt < k || key_less(cv, cp, tv, tp));
    unsigned m = __ballot_sync(kFull, want);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float nv = __shfl_sync(kFull, cv, src);
      const int np = __shfl_sync(kFull, cp, src);
      kth(k, tv, tp);
      if (cnt == k && !key_less(nv, np, tv, tp)) continue;
      int rank = 0;
#pragma unroll
      for (int s = 0; s < KPS; ++s)
        rank += __popc(__ballot_sync(
            kFull, 32 * s + lane < cnt && key_less(v[s], p[s], nv, np)));
      // shift the slots at or above rank up by one; slot 32 takes slot 31
      float up_v[KPS];
      int up_p[KPS];
#pragma unroll
      for (int s = 0; s < KPS; ++s) {
        up_v[s] = __shfl_up_sync(kFull, v[s], 1);
        up_p[s] = __shfl_up_sync(kFull, p[s], 1);
      }
      if (KPS == 2) {
        const float cv31 = __shfl_sync(kFull, v[0], 31);
        const int cp31 = __shfl_sync(kFull, p[0], 31);
        if (lane == 0) {
          up_v[KPS - 1] = cv31;
          up_p[KPS - 1] = cp31;
        }
      }
#pragma unroll
      for (int s = 0; s < KPS; ++s) {
        const int slot = 32 * s + lane;
        if (slot == rank) {
          v[s] = nv;
          p[s] = np;
        } else if (slot > rank) {
          v[s] = up_v[s];
          p[s] = up_p[s];
        }
      }
      cnt = min(cnt + 1, k);
    }
  }

  // a pool kept in shared memory: 32·KPS values, 32·KPS positions, count
  __device__ void load(const float* m) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < KPS; ++s) {
      v[s] = m[32 * s + lane];
      p[s] = reinterpret_cast<const int*>(m)[32 * (KPS + s) + lane];
    }
    cnt = reinterpret_cast<const int*>(m)[64 * KPS];
  }
  __device__ void save(float* m) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < KPS; ++s) {
      m[32 * s + lane] = v[s];
      reinterpret_cast<int*>(m)[32 * (KPS + s) + lane] = p[s];
    }
    if (lane == 0) reinterpret_cast<int*>(m)[64 * KPS] = cnt;
    __syncwarp();
  }

  __device__ void emit(float* out_v, int* out_p, int k, int sentinel) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < KPS; ++s) {
      const int slot = 32 * s + lane;
      if (slot < k) {
        out_v[slot] = slot < cnt ? v[s] : scan::inf();
        out_p[slot] = slot < cnt ? p[s] : sentinel;
      }
    }
  }
};

__device__ __forceinline__ int seg_len(const int* lens, int qi, int lmax) {
  return max(0, min(lens[qi], lmax));
}

// the operands every scan shares
struct Args {
  const float* q;
  const int* lq;
  const void* ax;
  const int* alw;
  const float* axn;
  const int* rc;
  int R;
  const int* starts;
  const int* lens;
  const uint8_t* tomb;
  const float* scales;
  const float* zeros;
  float* out_v;
  int* out_p;
  int Q, D, W, lmax, kp, span, splits;
  bool vec;
};

// Query qi over split sp, one thread per position (the per-query scan).
// smem holds D + 4·kp + 2·kThreads floats.  Every thread of the block must
// call it: it synchronizes.
template <int DT, bool L2, bool TOMB>
__device__ void scan_one(const Args& a, int qi, int sp, float* smem,
                         int* s_lq, float* s_qn, int* s_n) {
  const int lo = sp * a.span;
  const int hi = min(lo + a.span, seg_len(a.lens, qi, a.lmax));
  // splits past the segment's end are never read by the merge
  if (lo >= hi && a.splits > 1) return;

  __syncthreads();  // the block's previous user of smem is done
  float* qs = smem;  // [D]
  Pool P = make_pool(smem + a.D, a.kp, s_n);
  for (int e = threadIdx.x; e < a.D; e += kThreads)
    qs[e] = a.q[static_cast<long long>(qi) * a.D + e];
  if (threadIdx.x < a.W) s_lq[threadIdx.x] = a.lq[qi * a.W + threadIdx.x];
  if (threadIdx.x == 0) *s_n = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;  // ‖q‖², in order
    for (int e = 0; e < a.D; ++e) acc = scan::mac(acc, qs[e], qs[e]);
    *s_qn = acc;
  }
  __syncthreads();
  const float qn = *s_qn;
  const long long start = a.starts[qi];

  for (int base = lo; base < hi; base += kThreads) {
    const int pos = base + threadIdx.x;
    bool has = false;
    float d = 0.0f;
    if (pos < hi) {
      long long p = start + pos;
      p = p < 0 ? 0 : (p > a.R - 1 ? a.R - 1 : p);
      const long long gid = a.rc[p];
      if (scan::contains(s_lq, a.alw + gid * a.W, a.W) &&
          (!TOMB || scan::alive(a.tomb, gid))) {
        const float s = DT == scan::U8 ? a.scales[gid] : 0.0f;
        const float z = DT == scan::U8 ? a.zeros[gid] : 0.0f;
        const float ip = scan::row_sum<DT, false>(
            qs, scan::row_ptr(a.ax, DT, gid, a.D), a.D, a.vec, s, z);
        d = L2 ? scan::l2_norms_form(qn, ip, a.axn[gid]) : -ip;
        has = true;
      }
    }
    P.offer(has, d, pos);
  }
  __syncthreads();
  const long long o = (static_cast<long long>(qi) * a.splits + sp) * a.kp;
  P.emit(a.out_v + o, a.out_p + o, a.lmax);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 16 : 0));  // 0: zero-fill, nothing read
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// a.x, a.y, a.z or a.w
__device__ __forceinline__ float part(const float4& a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : (i == 2 ? a.z : a.w));
}

// The run of rq (> kNarrow) queries qf .. qf + rq − 1 of one segment over
// split sp: each tile of kBN rows is gathered once for all of them (file
// head).  lq_t / qn_t hold the run's label words and ‖q‖²; smem holds
// RunSmem<DT, KPS>::BYTES.  Rows are 16-byte aligned (Args::vec).  Every
// thread of the block must call it.
//
// The rows and queries of step s + 1 (kKC features) are copied with
// cp.async while step s is computed; a tile's row ids are copied during
// the first step of the tile before, and its labels, norms, scales and
// zeros during the second.  Nothing in flight occupies a register, and the
// running top-k' of query j lives in shared memory, owned by warp j % 8,
// so the register file holds the math alone.
template <int DT, bool L2, bool TOMB, int KPS>
__device__ void scan_run(const Args& a, int qf, int rq, int sp,
                         unsigned char* smem, const int (*lq_t)[kMaxWords],
                         float* qn_t) {
  using L = RunSmem<DT, KPS>;
  const int lo = sp * a.span;
  const int hi = min(lo + a.span, seg_len(a.lens, qf, a.lmax));
  if (lo >= hi && a.splits > 1) return;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  // query warp + 8·i of the run is this warp's for i < na (warp-uniform)
  const int na = rq > warp ? (rq - warp + 7) / 8 : 0;
  auto pool_of = [&](int j) {
    return reinterpret_cast<float*>(smem + L::POOL) + j * L::POOL_WORDS;
  };
  __syncthreads();  // the block's previous user of smem is done
  for (int i = 0; i < na; ++i) {
    WarpPool<KPS> P;
    P.init(a.lmax);
    P.save(pool_of(warp + 8 * i));
  }

  if (lo < hi) {
    const long long start = a.starts[qf];
    const int spt = (a.D + kKC - 1) / kKC;  // steps per row tile
    const int ntile = (hi - lo + kBN - 1) / kBN;
    const int total = ntile * spt;
    float* xf = reinterpret_cast<float*>(smem + L::XF);
    auto xs = [&](int buf) { return smem + L::XS + buf * kBN * L::RP; };
    auto qs = [&](int buf) {
      return reinterpret_cast<float*>(smem + L::QS) + buf * kTQ * kLD;
    };
    // metadata buffer `buf`: gid, ok, axn, scale, zero, label words
    auto gid_of = [&](int buf) {
      return reinterpret_cast<int*>(smem + L::META) + buf * kMetaWords;
    };
    auto ok_of = [&](int buf) { return gid_of(buf) + kBN; };
    auto axn_of = [&](int buf) {
      return reinterpret_cast<float*>(gid_of(buf) + 2 * kBN);
    };
    auto scl_of = [&](int buf) { return axn_of(buf) + kBN; };
    auto zr_of = [&](int buf) { return axn_of(buf) + 2 * kBN; };
    auto alw_of = [&](int buf) { return gid_of(buf) + 5 * kBN; };

    // row t < kBN of tile `tile`: its id, then (once the id is in) the
    // rest; async: cp.async, else plain loads
    auto meta_ids = [&](int tile, int buf, bool async) {
      if (t < kBN) {
        const int pos = lo + tile * kBN + t;
        long long p = start + pos;
        p = p < 0 ? 0 : (p > a.R - 1 ? a.R - 1 : p);
        if (async)
          cp_async4(gid_of(buf) + t, a.rc + p, pos < hi);
        else
          gid_of(buf)[t] = pos < hi ? a.rc[p] : 0;
      }
    };
    auto meta_rest = [&](int tile, int buf, bool async) {
      if (t < kBN) {
        const int pos = lo + tile * kBN + t;
        const long long gid = gid_of(buf)[t];
        const bool ok = pos < hi && (!TOMB || scan::alive(a.tomb, gid));
        ok_of(buf)[t] = ok;
        int* lw = alw_of(buf) + t * kMaxWords;
        if (async) {
          if (L2) cp_async4(axn_of(buf) + t, a.axn + gid, ok);
          if (DT == scan::U8) {
            cp_async4(scl_of(buf) + t, a.scales + gid, ok);
            cp_async4(zr_of(buf) + t, a.zeros + gid, ok);
          }
          for (int w = 0; w < a.W; ++w)
            cp_async4(lw + w, a.alw + gid * a.W + w, ok);
        } else {
          if (L2) axn_of(buf)[t] = ok ? a.axn[gid] : 0.0f;
          if (DT == scan::U8) {
            scl_of(buf)[t] = ok ? a.scales[gid] : 0.0f;
            zr_of(buf)[t] = ok ? a.zeros[gid] : 0.0f;
          }
          for (int w = 0; w < a.W; ++w) lw[w] = ok ? a.alw[gid * a.W + w] : 0;
        }
      }
    };

    // step s's rows (as stored) and queries into buffer s & 1, 16 bytes a
    // copy; rows past the tile's end, tombstoned rows and features past D
    // are zero-filled, not read
    auto issue = [&](int s) {
      const int mb = (s / spt) & 1, e0 = (s % spt) * kKC;
      unsigned char* xb = xs(s & 1);
      float* qb = qs(s & 1);
      for (int i = t; i < kBN * L::CPR; i += kThreads) {
        const int r = i / L::CPR, k = i % L::CPR;
        const bool ok = ok_of(mb)[r] && (e0 * L::ES + 16 * k) < a.D * L::ES;
        const char* src =
            static_cast<const char*>(
                scan::row_ptr(a.ax, DT, gid_of(mb)[r], a.D)) +
            e0 * L::ES + 16 * k;
        cp_async16(xb + r * L::RP + 16 * k,
                   ok ? static_cast<const void*>(src) : a.ax, ok);
      }
      for (int i = t; i < kTQ * (kKC / 4); i += kThreads) {
        const int j = i / (kKC / 4), k = i % (kKC / 4);
        const bool ok = j < rq && e0 + 4 * k < a.D;
        const float* src =
            a.q + static_cast<long long>(qf + j) * a.D + e0 + 4 * k;
        cp_async16(qb + j * kLD + 4 * k, ok ? src : a.q, ok);
      }
    };
    // the f16 / int8 rows of step s widened into xf (int8 dequantized
    // exactly as scan::load16 does)
    auto widen_step = [&](int s) {
      const int mb = (s / spt) & 1;
      const unsigned char* xb = xs(s & 1);
      for (int i = t; i < kBN * kKC; i += kThreads) {
        const int r = i / kKC, e = i % kKC;
        const unsigned char* row = xb + r * L::RP;
        float v;
        if (DT == scan::F16)
          v = __half2float(reinterpret_cast<const __half*>(row)[e]);
        else
          v = scan::dequant(static_cast<float>(row[e]), scl_of(mb)[r],
                            zr_of(mb)[r]);
        xf[r * kLD + e] = v;
      }
    };

    float acc[kRQ][kRN];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] = 0.0f;
    float qn = 0.0f;  // thread t < rq: ‖q‖² of query t, in order, in tile 0

    meta_ids(0, 0, false);
    meta_rest(0, 0, false);
    __syncthreads();
    issue(0);
    cp_async_commit();
    for (int tile = 0; tile < ntile; ++tile) {
      const bool next = tile + 1 < ntile;
      const int nb = (tile + 1) & 1;
      for (int c = 0; c < spt; ++c) {
        const int s = tile * spt + c;
        if (c == 1 && next)
          cp_async_wait_all_but_last();  // tile + 1's labels may stay out
        else
          cp_async_wait_all();
        __syncthreads();  // step s is in; step s − 1's readers are done
        if (c == 0 && next) {
          if (spt == 1) {  // no later step of this tile to hide it in
            meta_ids(tile + 1, nb, false);
            meta_rest(tile + 1, nb, false);
            __syncthreads();
          } else {
            meta_ids(tile + 1, nb, true);
          }
        }
        if (s + 1 < total) issue(s + 1);  // in flight during the math
        cp_async_commit();
        if (DT != scan::F32) {
          widen_step(s);
          __syncthreads();
        }
        const float* xb = DT != scan::F32
                              ? xf
                              : reinterpret_cast<const float*>(xs(s & 1));
        const float* qb = qs(s & 1);
        const int kc = min(kKC, a.D - (s % spt) * kKC);  // features
        for (int e = 0; e < kc; e += 4) {  // zeros past D: exact no-ops
          // the warp's queries (zero rows past the run: computed, never
          // offered), one broadcast load each
          float4 qa[kRQ];
#pragma unroll
          for (int i = 0; i < kRQ; ++i)
            qa[i] = *reinterpret_cast<const float4*>(
                qb + (warp + 8 * i) * kLD + e);
#pragma unroll
          for (int j = 0; j < kRN; ++j) {
            const float4 xv = *reinterpret_cast<const float4*>(
                xb + (lane + 32 * j) * kLD + e);
            // one feature at a time over the warp's queries: kRQ chains
            // of rounded adds side by side
#pragma unroll
            for (int f = 0; f < 4; ++f)
#pragma unroll
              for (int i = 0; i < kRQ; ++i)
                acc[i][j] = scan::mac(acc[i][j], part(xv, f), part(qa[i], f));
          }
        }
        if (tile == 0 && t < rq) {
          for (int e = 0; e < kc; ++e)
            qn = scan::mac(qn, qb[t * kLD + e], qb[t * kLD + e]);
          if (c == spt - 1) qn_t[t] = qn;
        }
        if (c == 0 && next && spt > 1) {  // tile + 1's ids are in
          cp_async_wait_all();
          meta_rest(tile + 1, nb, true);
          cp_async_commit();
        }
      }
      if (tile == 0) __syncthreads();  // qn_t
      // the finished tile: label filter, tombstones, distances, each
      // query's candidates offered from the registers of its warp
      const int mb = tile & 1, n0 = lo + tile * kBN;
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        if (i >= na) continue;  // warp-uniform
        const int j = warp + 8 * i;
        WarpPool<KPS> P;
        P.load(pool_of(j));
#pragma unroll
        for (int jj = 0; jj < kRN; ++jj) {
          const int c = lane + 32 * jj;
          bool keep = ok_of(mb)[c];
          if (keep)
            keep = scan::contains(lq_t[j], alw_of(mb) + c * kMaxWords, a.W);
          const float d = L2 ? scan::l2_norms_form(qn_t[j], acc[i][jj],
                                                   axn_of(mb)[c])
                             : -acc[i][jj];
          P.offer(keep ? d : scan::inf(), n0 + c, a.kp);
          acc[i][jj] = 0.0f;
        }
        P.save(pool_of(j));
      }
    }
    cp_async_wait_all();
  }
  for (int i = 0; i < na; ++i) {
    const int j = warp + 8 * i;
    WarpPool<KPS> P;
    P.load(pool_of(j));
    const long long o = (static_cast<long long>(qf + j) * a.splits + sp) * a.kp;
    P.emit(a.out_v + o, a.out_p + o, a.kp, a.lmax);
  }
}

// one block per (query, span split)
template <int DT, bool L2, bool TOMB>
__global__ void __launch_bounds__(kThreads) fused_scan_partial(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lq[kMaxWords];
  __shared__ float s_qn;
  __shared__ int s_n;
  scan_one<DT, L2, TOMB>(a, blockIdx.y, blockIdx.x, smem, s_lq, &s_qn, &s_n);
}

// one block per (tile of bq ≤ kTQ consecutive queries, span split): the
// tile's runs of equal segments in turn
template <int DT, bool L2, bool TOMB, int KPS>
__global__ void __launch_bounds__(kThreads, 2) fused_scan_tile(Args a,
                                                               int bq) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int lq_t[kTQ][kMaxWords];
  __shared__ float qn_t[kTQ];
  __shared__ int run_at[kTQ + 1];
  __shared__ int n_runs;
  __shared__ int s_lq[kMaxWords];
  __shared__ float s_qn;
  __shared__ int s_n;
  const int q0 = blockIdx.y * bq, sp = blockIdx.x;
  const int nq = min(bq, a.Q - q0);
  if (threadIdx.x == 0) {  // runs: maximal groups of equal (start, len)
    int n = 0;
    for (int j = 0; j < nq; ++j)
      if (j == 0 || a.starts[q0 + j] != a.starts[q0 + j - 1] ||
          a.lens[q0 + j] != a.lens[q0 + j - 1])
        run_at[n++] = j;
    run_at[n] = nq;
    n_runs = n;
  }
  __syncthreads();
  const int runs = n_runs;
  for (int r = 0; r < runs; ++r) {
    const int r0 = run_at[r], rq = run_at[r + 1] - r0;
    if (rq <= kNarrow) {
      for (int j = 0; j < rq; ++j)
        scan_one<DT, L2, TOMB>(a, q0 + r0 + j, sp, smem, s_lq, &s_qn, &s_n);
      continue;
    }
    __syncthreads();  // lq_t's previous readers are done
    for (int i = threadIdx.x; i < rq * a.W; i += kThreads)
      lq_t[i / a.W][i % a.W] =
          a.lq[static_cast<long long>(q0 + r0 + i / a.W) * a.W + i % a.W];
    scan_run<DT, L2, TOMB, KPS>(a, q0 + r0, rq, sp,
                                reinterpret_cast<unsigned char*>(smem), lq_t,
                                qn_t);
  }
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

// raise a kernel's dynamic shared-memory limit to `bytes` (once per size)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// dynamic shared memory of a block: one query's scan, and a tile's
size_t one_query_bytes(int D, int kp) {
  return static_cast<size_t>(D + 4 * kp + 2 * kThreads) * sizeof(float);
}
template <int DT, int KPS>
size_t tile_bytes(int D, int kp) {
  const size_t one = one_query_bytes(D, kp);
  const size_t run = RunSmem<DT, KPS>::BYTES;
  return one > run ? one : run;
}

template <int DT, bool L2, bool TOMB>
cudaError_t launch(const Args& a, int bq, cudaStream_t st) {
  const int Q = a.Q;
  const size_t one = one_query_bytes(a.D, a.kp);
  if (bq <= 1) {
    static size_t allowed = 0;
    const cudaError_t err =
        allow_smem(fused_scan_partial<DT, L2, TOMB>, one, allowed);
    if (err != cudaSuccess) return err;
    fused_scan_partial<DT, L2, TOMB>
        <<<dim3(a.splits, Q), kThreads, one, st>>>(a);
    return cudaGetLastError();
  }
  const dim3 grid(a.splits, (Q + bq - 1) / bq);
  if (a.kp <= 32) {
    const size_t bytes = tile_bytes<DT, 1>(a.D, a.kp);
    static size_t allowed = 0;
    const cudaError_t err =
        allow_smem(fused_scan_tile<DT, L2, TOMB, 1>, bytes, allowed);
    if (err != cudaSuccess) return err;
    fused_scan_tile<DT, L2, TOMB, 1><<<grid, kThreads, bytes, st>>>(a, bq);
  } else {
    const size_t bytes = tile_bytes<DT, 2>(a.D, a.kp);
    static size_t allowed = 0;
    const cudaError_t err =
        allow_smem(fused_scan_tile<DT, L2, TOMB, 2>, bytes, allowed);
    if (err != cudaSuccess) return err;
    fused_scan_tile<DT, L2, TOMB, 2><<<grid, kThreads, bytes, st>>>(a, bq);
  }
  return cudaGetLastError();
}

template <int DT>
cudaError_t dispatch(bool l2, bool tomb_on, const Args& a, int bq,
                     cudaStream_t st) {
  if (l2 && tomb_on) return launch<DT, true, true>(a, bq, st);
  if (l2) return launch<DT, true, false>(a, bq, st);
  if (tomb_on) return launch<DT, false, true>(a, bq, st);
  return launch<DT, false, false>(a, bq, st);
}

}  // namespace

// dynamic shared memory of a block of query tile bq (dtype as below)
extern "C" int fused_scan_smem_bytes(int dtype, int D, int kp, int bq) {
  if (bq <= 1) return static_cast<int>(one_query_bytes(D, kp));
  const bool two = kp > 32;
  if (dtype == scan::F32)
    return static_cast<int>(two ? tile_bytes<scan::F32, 2>(D, kp)
                                : tile_bytes<scan::F32, 1>(D, kp));
  if (dtype == scan::F16)
    return static_cast<int>(two ? tile_bytes<scan::F16, 2>(D, kp)
                                : tile_bytes<scan::F16, 1>(D, kp));
  return static_cast<int>(two ? tile_bytes<scan::U8, 2>(D, kp)
                              : tile_bytes<scan::U8, 1>(D, kp));
}

// q [Q, D] f32, lq [Q, W] i32, ax [N, D] (dtype 0 f32 / 1 f16 / 2 u8),
// alw [N, W] i32, axn [N] f32, rc [R] i32, starts/lens [Q] i32, tomb
// [⌈N/8⌉] u8 or null, scales/zeros [N] f32 (u8 only) -> out_v [Q, kp] f32,
// out_p [Q, kp] i32 (W ≤ 8).  bq ≤ 1: one block per (query, span split);
// 2 ≤ bq ≤ 64 (kp ≤ 64, vec): one per (tile of bq queries, span split).
// With splits > 1, part_v/part_p [Q, splits, kp] are the per-split
// scratch.  Returns cudaGetLastError().
extern "C" int fused_scan(const float* q, const int* lq, const void* ax,
                          const int* alw, const float* axn, const int* rc,
                          int R, const int* starts, const int* lens,
                          const uint8_t* tomb, const float* scales,
                          const float* zeros, float* part_v, int* part_p,
                          float* out_v, int* out_p, int Q, int D, int W,
                          int lmax, int kp, int span, int splits, int bq,
                          int dtype, int metric_ip, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{q,      lq,    ax,     alw,  axn,   rc,   R,    starts,
         lens,   tomb,  scales, zeros,
         splits > 1 ? part_v : out_v, splits > 1 ? part_p : out_p,
         Q,      D,     W,      lmax, kp,    span, splits, vec != 0};
  const bool l2 = metric_ip == 0;
  const bool tomb_on = tomb != nullptr;
  cudaError_t err;
  if (dtype == scan::F32)
    err = dispatch<scan::F32>(l2, tomb_on, a, bq, st);
  else if (dtype == scan::F16)
    err = dispatch<scan::F16>(l2, tomb_on, a, bq, st);
  else
    err = dispatch<scan::U8>(l2, tomb_on, a, bq, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t pool_bytes =
      static_cast<size_t>(4 * kp + 2 * kThreads) * sizeof(float);
  fused_scan_merge<<<Q, kThreads, pool_bytes, st>>>(
      part_v, part_p, lens, out_v, out_p, lmax, kp, span, splits);
  return static_cast<int>(cudaGetLastError());
}
