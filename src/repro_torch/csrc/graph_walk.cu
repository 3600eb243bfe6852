// The graph backend's filtered beam search as one walk a query lane, on
// the device (sm_90a).
//
// Carries src/repro/kernels/gather_distance.py::gather_distance_pallas
// (one grid step per scattered candidate row, its id scalar-prefetched;
// the TPU kernel computes a hop's neighbour distances and leaves the hop
// loop to the JAX program that calls it): the hop's distances are computed
// here, inside the walk, in that kernel's DIRECT form.  The walk itself is
// the per-lane loop of src/repro/index/graph.py::_beam_search_batch (its
// lax.while_loop over one lane's state, vmapped over the batch), and the
// port's plain version is kernels/graph_walk.py::graph_walk_plain, the
// torch loop over hops on [bucket, ·] state.
//
// out for lane b: the k best (dist, id) of the result pool (id N: empty),
// the hops it expanded and the distance computations it made, equal bit
// for bit to the plain version's lane b:
//   * pools: the candidate pool (navigation, with expanded flags) and the
//     result pool (passing live nodes), each ef wide and kept sorted.  A
//     hop merges a pool with its new entries as one stable sort of
//     [pool, new] would: a pool entry lands at its index plus the count of
//     new entries strictly below it, a new entry at its rank among the new
//     ones (ties in slot order) plus the count of pool entries at or below
//     it; only the first ef are kept.  Values compare with float '<', so
//     -0.0 equals +0.0 as the plain version's sort key d + 0.0 does; the
//     value's own bits are stored.  A new entry at +inf or NaN never lands.
//   * seeding: the candidate pool is the entries (stably sorted), then ef
//     fill slots (+inf, N) marked expanded; the result pool is ef fill
//     slots merged with the passing entries.
//   * visited: a bitmap over the N + 1 node ids a lane, in a global
//     workspace the kernel zeroes; the sink N is set, and so is every seed.
//     A hop's M neighbours are tested before any of them is set (a
//     duplicate id in one adjacency row counts twice, as in the loop): the
//     first lane of each group of equal ids sets the bit with one atomicOr
//     and hands the word it read to the group.
//   * distances: direct form sum((q − x)²), or −sum(q·x) for ip, one rounded
//     subtract, multiply and add per feature in order over D (scan::mac's
//     rule, never an FMA: ROADMAP C0), so a value equals gather_kernel's
//     and the plain version's bit for bit.
//   * strategy: pre navigates on passing neighbours, post on every
//     unvisited one; the result pool takes passing live ones.
//   * stopping: before each hop, the lane stops when hops ≥ max_steps, or
//     when its first unexpanded candidate (sorted pools make it the least)
//     is not finite or lies above the ef-th result.  The plain loop freezes
//     a finished lane, so its result is the state at that first stop.
//
// Bound on the card.  A lane's walk is a dependent chain of hops: the
// adjacency row, the visited words and label words, the rows of the fresh
// neighbours, their sums and the merge, each waiting on the one before.
// Its bytes (distance computations × 4·D, hops × M × 8 for the adjacency)
// are far below what that chain takes, so latency, not bytes, bounds it.
//
// Design.  One warp owns one lane for its whole walk, one warp a block, so
// a bucket of B lanes spreads over min(B, 132) SMs.  Query row, label
// words, both pools and a staging buffer for M rows live in dynamic shared
// memory.  Per hop: a ballot over the expanded flags finds the slot; lane t
// < M reads neighbour t, tests and sets its visited bit and, if fresh, its
// labels and tombstone; the fresh rows are staged by the warp with
// coalesced 16-byte loads (row pitch D + 4 floats: conflict-free 16-byte
// reads) and lane r sums row r; a shuffle hands each neighbour its value;
// the new entries are compacted in slot order and both pools merged in
// place (pool entries only move right, so chunks of 32 move from the top
// down).  No host read happens inside the walk.
//
// FAULT, a template parameter, plants a fault for the checks that must
// reject it; only graph_walk_planted instantiates it, graph_walk runs 0:
// 1 merges new entries ahead of equal pool entries, 2 stops each lane one
// hop early (the lane walks once to count its hops, then again to one
// fewer).
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNew = 32;  // new entries a merge takes: M ≤ 32, E ≤ 32

struct Args {
  const float* q;          // [B, D]
  const int* lq;           // [B, W]
  const long long* entries;  // [B, E], -1: no seed
  const float* x;          // [N, D]
  const long long* adj;    // [N + 1, M], pads and row N hold N
  const int* lxw;          // [N + 1, W]
  const uint8_t* tomb;     // packed bitmap, bit set: deleted (or null)
  long long tomb_bytes;
  unsigned* visited;       // [B, vwords] workspace
  long long vwords;        // a multiple of 4
  float* out_d;            // [B, k]
  int* out_i;              // [B, k]
  int* hops;               // [B]
  int* dc;                 // [B]
  int B, E, N, M, D, W, k, ef, max_steps, pre;
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// byte offsets of one block's dynamic shared memory (the wrapper's
// walk_smem_bytes mirrors BYTES)
struct Layout {
  int qs, xs, pd, pi, rd, ri, px, npd, npi, nrd, nri, need, lq, bytes, sd;
  __host__ __device__ Layout(int D, int M, int ef, int W, bool vec) {
    sd = vec ? D + 4 : D + 1;  // staged row pitch, floats
    int o = 0;
    qs = o;   o += align16(4 * D);
    xs = o;   o += align16(4 * M * sd);
    pd = o;   o += align16(4 * ef);
    pi = o;   o += align16(4 * ef);
    rd = o;   o += align16(4 * ef);
    ri = o;   o += align16(4 * ef);
    px = o;   o += align16(ef);
    npd = o;  o += 4 * kNew;
    npi = o;  o += 4 * kNew;
    nrd = o;  o += 4 * kNew;
    nri = o;  o += 4 * kNew;
    need = o; o += 4 * kNew;
    lq = o;   o += align16(4 * W);
    bytes = o;
  }
};

template <bool IP>
__device__ __forceinline__ float step(float acc, float qe, float xe) {
  if (IP) return scan::mac(acc, xe, qe);
  const float t = __fsub_rn(qe, xe);
  return __fadd_rn(acc, __fmul_rn(t, t));
}

// a row staged in shared memory (16-byte aligned with VEC)
template <bool IP, bool VEC>
__device__ float dist_staged(const float* qs, const float* xr, int D) {
  float acc = 0.0f;
  if (VEC) {
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int g = 0; g < (D >> 2); ++g) {
      const float4 a = q4[g], v = x4[g];
      acc = step<IP>(acc, a.x, v.x);
      acc = step<IP>(acc, a.y, v.y);
      acc = step<IP>(acc, a.z, v.z);
      acc = step<IP>(acc, a.w, v.w);
    }
  } else {
    for (int e = 0; e < D; ++e) acc = step<IP>(acc, qs[e], xr[e]);
  }
  return IP ? -acc : acc;
}

// a seed's row, read from device memory by one thread
template <bool IP>
__device__ float dist_row(const float* qs, const float* row, int D) {
  float acc = 0.0f;
  for (int e = 0; e < D; ++e) acc = step<IP>(acc, qs[e], __ldg(row + e));
  return IP ? -acc : acc;
}

// tombstone bit of `id` (little bit order, the byte index clamped to the
// bitmap as ref.tombstone_mask clamps it), true = alive
__device__ __forceinline__ bool alive(const uint8_t* tomb, long long bytes,
                                      int id) {
  if (tomb == nullptr) return true;
  long long byte = id >> 3;
  if (byte > bytes - 1) byte = bytes - 1;
  return ((tomb[byte] >> (id & 7)) & 1) == 0;
}

// Merge the n (≤ 32) new entries nd/ni (finite, in slot order) into the
// sorted pool pd/pi(/px) of ef slots, keeping the first ef of the stable
// sort of [pool, new].  AHEAD is planted fault 1.
template <bool AHEAD>
__device__ void merge(float* pd, int* pi, uint8_t* px, int ef,
                      const float* nd, const int* ni, int n, int lane) {
  if (n == 0) return;
  float v = 0.0f;
  int vid = 0, vpos = ef;
  if (lane < n) {
    v = nd[lane];
    vid = ni[lane];
    int r = 0;
    for (int m = 0; m < n; ++m) {
      const float o = nd[m];
      r += (o < v) || (m < lane && o == v);
    }
    int lo = 0, hi = ef;  // pool entries at or below v (below: fault 1)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const float p = pd[mid];
      if (AHEAD ? p < v : p <= v)
        lo = mid + 1;
      else
        hi = mid;
    }
    vpos = r + lo;
  }
  // pool entries move right only: chunks of 32 from the top down
  for (int base = (ef - 1) & ~31; base >= 0; base -= 32) {
    const int j = base + lane;
    float d = 0.0f;
    int id = 0, pos = j;
    uint8_t xf = 0;
    if (j < ef) {
      d = pd[j];
      id = pi[j];
      if (px) xf = px[j];
      int c = 0;
      for (int m = 0; m < n; ++m) {
        const float o = nd[m];
        c += AHEAD ? (o <= d) : (o < d);
      }
      pos = j + c;
    }
    __syncwarp();
    if (j < ef && pos != j && pos < ef) {
      pd[pos] = d;
      pi[pos] = id;
      if (px) px[pos] = xf;
    }
    __syncwarp();
  }
  if (vpos < ef) {
    pd[vpos] = v;
    pi[vpos] = vid;
    if (px) px[vpos] = 0;
  }
  __syncwarp();
}

struct Smem {
  float *qs, *xs, *pd, *rd, *npd, *nrd;
  int *pi, *ri, *npi, *nri, *need, *lq;
  uint8_t* px;
  int sd;
};

// One lane's walk up to `limit` hops: seeds, walks, leaves both pools in
// shared memory; returns its hops and sets dc.
template <bool IP, bool VEC, int FAULT>
__device__ int walk(const Args& a, const Smem& s, int b, int limit,
                    int& dc) {
  const int lane = threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  const float inf = scan::inf();
  const int N = a.N, M = a.M, D = a.D, W = a.W, ef = a.ef;
  unsigned* vis = a.visited + static_cast<long long>(b) * a.vwords;

  // seeds
  bool valid = false;
  int seed = N;
  if (lane < a.E) {
    const long long e = a.entries[static_cast<long long>(b) * a.E + lane];
    valid = e >= 0;
    if (valid) seed = static_cast<int>(e);
  }
  const unsigned vm = __ballot_sync(kFull, valid);
  if (vm) {
    uint4* v4 = reinterpret_cast<uint4*>(vis);
    for (long long i = lane; i < (a.vwords >> 2); i += 32)
      v4[i] = make_uint4(0u, 0u, 0u, 0u);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) atomicOr(vis + (N >> 5), 1u << (N & 31));
    if (lane < a.E) atomicOr(vis + (seed >> 5), 1u << (seed & 31));
    __threadfence_block();
    __syncwarp();
  }
  float ed = inf;
  bool epass = false;
  if (valid) {
    ed = dist_row<IP>(s.qs, a.x + static_cast<long long>(seed) * D, D);
    epass = scan::contains(s.lq, a.lxw + static_cast<long long>(seed) * W,
                           W) &&
            alive(a.tomb, a.tomb_bytes, seed);
  }
  // candidate pool: the entries stably sorted (NaN last, never kept), then
  // fill slots
  if (lane < a.E) s.npd[lane] = ed;
  __syncwarp();
  const bool num = lane < a.E && ed == ed;
  const int nonnan = __popc(__ballot_sync(kFull, num));
  if (num) {
    int r = 0;
    for (int m = 0; m < a.E; ++m) {
      const float o = s.npd[m];
      r += (o < ed) || (m < lane && o == ed);
    }
    if (r < ef) {
      s.pd[r] = ed;
      s.pi[r] = seed;
      s.px[r] = valid ? 0 : 1;
    }
  }
  for (int j = nonnan + lane; j < ef; j += 32) {
    s.pd[j] = inf;
    s.pi[j] = N;
    s.px[j] = 1;
  }
  for (int j = lane; j < ef; j += 32) {
    s.rd[j] = inf;
    s.ri[j] = N;
  }
  __syncwarp();
  // result pool: the fill slots merged with the passing entries
  const bool rok = epass && ed < inf;
  const unsigned rm0 = __ballot_sync(kFull, rok);
  if (rok) {
    s.nrd[__popc(rm0 & lt)] = ed;
    s.nri[__popc(rm0 & lt)] = seed;
  }
  __syncwarp();
  merge<FAULT == 1>(s.rd, s.ri, nullptr, ef, s.nrd, s.nri, __popc(rm0),
                   lane);
  dc = __popc(vm);
  const unsigned mmask = M == 32 ? kFull : ((1u << M) - 1u);
  int hops = 0;
  while (hops < limit) {
    int slot = -1;
    for (int base = 0; base < ef; base += 32) {
      const int j = base + lane;
      const unsigned m = __ballot_sync(kFull, j < ef && s.px[j] == 0);
      if (m) {
        slot = base + __ffs(m) - 1;
        break;
      }
    }
    if (slot < 0) break;
    const float best = s.pd[slot];
    if (!(fabsf(best) < inf) || !(best <= s.rd[ef - 1])) break;
    const int u = s.pi[slot];
    __syncwarp();
    if (lane == 0) s.px[slot] = 1;

    // neighbours: visited test-and-set, labels, tombstones
    int nb = N;
    bool nv = false;
    if (lane < M) {
      nb = static_cast<int>(__ldg(a.adj + static_cast<long long>(u) * M +
                                  lane));
      const unsigned grp = __match_any_sync(mmask, nb);
      const int leader = __ffs(grp) - 1;
      unsigned old = 0;
      if (lane == leader) old = atomicOr(vis + (nb >> 5), 1u << (nb & 31));
      old = __shfl_sync(mmask, old, leader);
      nv = ((old >> (nb & 31)) & 1u) == 0;
    }
    bool npass = false, nres = false;
    if (nv) {
      npass = scan::contains(s.lq, a.lxw + static_cast<long long>(nb) * W,
                             W);
      nres = npass && alive(a.tomb, a.tomb_bytes, nb);
    }
    // distances of the fresh neighbours a pool can take (pre: passing)
    const bool need = nv && (!a.pre || npass);
    const unsigned needm = __ballot_sync(kFull, need);
    const int nneed = __popc(needm);
    const int r = __popc(needm & lt);
    if (need) s.need[r] = nb;
    __syncwarp();
    if (VEC) {
      const int d4 = D >> 2, sd4 = s.sd >> 2;
      const int total = nneed * d4;
      const float4* x4 = reinterpret_cast<const float4*>(a.x);
      float4* xs4 = reinterpret_cast<float4*>(s.xs);
      for (int c0 = 0; c0 < total; c0 += 32 * 8) {
        float4 v[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int c = c0 + 32 * w + lane;
          if (c < total) {
            const int row = c / d4;
            v[w] = __ldg(x4 + static_cast<long long>(s.need[row]) * d4 +
                         (c - row * d4));
          }
        }
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int c = c0 + 32 * w + lane;
          if (c < total) {
            const int row = c / d4;
            xs4[row * sd4 + (c - row * d4)] = v[w];
          }
        }
      }
    } else {
      const int total = nneed * D;
      for (int c0 = 0; c0 < total; c0 += 32 * 8) {
        float v[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int c = c0 + 32 * w + lane;
          if (c < total) {
            const int row = c / D;
            v[w] = __ldg(a.x + static_cast<long long>(s.need[row]) * D +
                         (c - row * D));
          }
        }
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int c = c0 + 32 * w + lane;
          if (c < total) {
            const int row = c / D;
            s.xs[row * s.sd + (c - row * D)] = v[w];
          }
        }
      }
    }
    __syncwarp();
    float mine = 0.0f;
    if (lane < nneed) mine = dist_staged<IP, VEC>(s.qs, s.xs + lane * s.sd, D);
    const float d = __shfl_sync(kFull, mine, need ? r : 0);

    // new entries in slot order, then both merges
    const bool pok = (a.pre ? npass : nv) && d < inf;
    const bool qok = nres && d < inf;
    const unsigned pm = __ballot_sync(kFull, pok);
    const unsigned qm = __ballot_sync(kFull, qok);
    if (pok) {
      s.npd[__popc(pm & lt)] = d;
      s.npi[__popc(pm & lt)] = nb;
    }
    if (qok) {
      s.nrd[__popc(qm & lt)] = d;
      s.nri[__popc(qm & lt)] = nb;
    }
    __syncwarp();
    merge<FAULT == 1>(s.pd, s.pi, s.px, ef, s.npd, s.npi, __popc(pm), lane);
    merge<FAULT == 1>(s.rd, s.ri, nullptr, ef, s.nrd, s.nri, __popc(qm),
                      lane);
    dc += __popc(__ballot_sync(kFull, nv));
    ++hops;
  }
  return hops;
}

template <bool IP, bool VEC, int FAULT>
__global__ void __launch_bounds__(32) graph_walk_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const Layout L(a.D, a.M, a.ef, a.W, VEC);
  Smem s;
  s.qs = reinterpret_cast<float*>(smem + L.qs);
  s.xs = reinterpret_cast<float*>(smem + L.xs);
  s.pd = reinterpret_cast<float*>(smem + L.pd);
  s.pi = reinterpret_cast<int*>(smem + L.pi);
  s.rd = reinterpret_cast<float*>(smem + L.rd);
  s.ri = reinterpret_cast<int*>(smem + L.ri);
  s.px = smem + L.px;
  s.npd = reinterpret_cast<float*>(smem + L.npd);
  s.npi = reinterpret_cast<int*>(smem + L.npi);
  s.nrd = reinterpret_cast<float*>(smem + L.nrd);
  s.nri = reinterpret_cast<int*>(smem + L.nri);
  s.need = reinterpret_cast<int*>(smem + L.need);
  s.lq = reinterpret_cast<int*>(smem + L.lq);
  s.sd = L.sd;
  for (int e = lane; e < a.D; e += 32)
    s.qs[e] = a.q[static_cast<long long>(b) * a.D + e];
  for (int w = lane; w < a.W; w += 32)
    s.lq[w] = a.lq[static_cast<long long>(b) * a.W + w];
  __syncwarp();
  int dc = 0;
  int hops = walk<IP, VEC, FAULT>(a, s, b, a.max_steps, dc);
  if (FAULT == 2 && hops > 0)
    hops = walk<IP, VEC, FAULT>(a, s, b, hops - 1, dc);
  for (int j = lane; j < a.k; j += 32) {
    a.out_d[static_cast<long long>(b) * a.k + j] = s.rd[j];
    a.out_i[static_cast<long long>(b) * a.k + j] = s.ri[j];
  }
  if (lane == 0) {
    a.hops[b] = hops;
    a.dc[b] = dc;
  }
}

template <bool IP, bool VEC, int FAULT>
cudaError_t launch(const Args& a, int bytes, cudaStream_t st) {
  static int opted = 48 * 1024;
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        graph_walk_kernel<IP, VEC, FAULT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted = bytes;
  }
  graph_walk_kernel<IP, VEC, FAULT><<<a.B, 32, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int FAULT>
int launch_walk(const Args& a, int ip, int vec, void* stream) {
  const int bytes = Layout(a.D, a.M, a.ef, a.W, vec != 0).bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ip)
    err = vec ? launch<true, true, FAULT>(a, bytes, st)
              : launch<true, false, FAULT>(a, bytes, st);
  else
    err = vec ? launch<false, true, FAULT>(a, bytes, st)
              : launch<false, false, FAULT>(a, bytes, st);
  return static_cast<int>(err);
}

}  // namespace

// Dynamic shared memory of one lane's block (the wrapper's walk_smem_bytes
// must agree).
extern "C" int graph_walk_smem_bytes(int D, int M, int ef, int W, int vec) {
  return Layout(D, M, ef, W, vec != 0).bytes;
}

// The walk of B lanes, one block each; see the head of this file.  vec:
// D % 4 == 0 and x 16-byte aligned (16-byte row copies).  Returns
// cudaGetLastError().
extern "C" int graph_walk(const float* q, const int* lq,
                          const long long* entries, const float* x,
                          const long long* adj, const int* lxw,
                          const uint8_t* tomb, long long tomb_bytes,
                          unsigned* visited, long long vwords, float* out_d,
                          int* out_i, int* hops, int* dc, int B, int E, int N,
                          int M, int D, int W, int k, int ef, int max_steps,
                          int metric_ip, int pre, int vec, void* stream) {
  const Args a{q,     lq,    entries, x,  adj,  lxw, tomb, tomb_bytes,
               visited, vwords, out_d, out_i, hops, dc, B, E, N, M, D, W,
               k,     ef,    max_steps, pre};
  return launch_walk<0>(a, metric_ip, vec, stream);
}

// graph_walk with planted fault 1 or 2 (see the head of this file), for
// the checks that must reject it; -1 for another fault.
extern "C" int graph_walk_planted(
    const float* q, const int* lq, const long long* entries, const float* x,
    const long long* adj, const int* lxw, const uint8_t* tomb,
    long long tomb_bytes, unsigned* visited, long long vwords, float* out_d,
    int* out_i, int* hops, int* dc, int B, int E, int N, int M, int D, int W,
    int k, int ef, int max_steps, int metric_ip, int pre, int vec, int fault,
    void* stream) {
  const Args a{q,     lq,    entries, x,  adj,  lxw, tomb, tomb_bytes,
               visited, vwords, out_d, out_i, hops, dc, B, E, N, M, D, W,
               k,     ef,    max_steps, pre};
  if (fault == 1) return launch_walk<1>(a, metric_ip, vec, stream);
  if (fault == 2) return launch_walk<2>(a, metric_ip, vec, stream);
  return -1;
}
