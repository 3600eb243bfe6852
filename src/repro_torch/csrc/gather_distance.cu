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
// Bound on the card.  Each live pair reads one scattered storage row
// (D x 4/2/1 bytes), its W label words and, for int8, its scale and zero,
// for ~3·D flops: far under the ridge point, so this kernel's own traffic
// is bytes.  Where many queries list the same rows (the top tier of the
// main path), the least the function needs — each row read once — is
// bound by the operations instead.
// Design: one thread per (query, candidate) pair, the query row staged
// once per block in shared memory, 16-byte row loads, and no row read at
// all for pairs that fail the length or label test.  Rows are scattered,
// so a warp's loads are not coalesced across threads; each thread's own
// row is read in full 32-byte sectors.
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
// (u8 only, else null) -> out [Q, L] f32.  Returns cudaGetLastError().
extern "C" int seg_gather_distance(const float* q, const int* lq,
                                   const void* x, const int* lxw,
                                   const int* gids, const int* lens,
                                   const float* scales, const float* zeros,
                                   float* out, int Q, int L, int D, int W,
                                   int dtype, int metric_ip, int vec,
                                   void* stream) {
  const dim3 grid((L + kThreads - 1) / kThreads, Q);
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
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
