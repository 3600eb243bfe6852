// The dense label-filtered distance tile shared by masked_distance.cu and
// filtered_topk.cu (sm_90a): the port of the Pallas helpers
// _distance_tile and _containment (src/repro/kernels/masked_distance.py).
//
// One block of 256 threads computes a [BQ, BN] tile of
//
//   d[i, j] = -ip                        (ip)
//           = (‖q_i‖² − 2·ip) + ‖x_j‖²   (l2, the Pallas kernel's norms form)
//   d[i, j] = +inf  where lq_i ⊄ lx_j or row j lies at or past `n_end`
//
// with ip = Σ_e q_i[e]·x_j[e].
//
// Arithmetic contract.  Every inner product, and every ‖q‖² and ‖x‖², is
// one chain of fused multiply-adds, acc = fma(a_e, b_e, acc) for
// e = 0 .. D-1 in order, from acc = 0 (features past D are zero-filled:
// fma(0, 0, acc) = acc).  So a value depends on its two rows alone — not
// on Q, the Q-bucket, the instance (BQ), the tile, the span split or the
// grid — which is what holds batched == looped and B3 == B4 bitwise on
// the card.  The FMA is what lets the CUDA cores reach their full
// 67 TFLOP/s; a rounded multiply then a rounded add (scan::mac, which B1,
// B2 and B5 keep) is two instructions and halves that.  The dense tile
// has no eager-torch value to match bit for bit (its plain version sums
// with torch's reduction, its oracle with a matmul), so against them it
// holds the parity tier: integer data bitwise (every product and partial
// sum is exact either way), random data rtol 1e-5.  No tensor cores:
// TF32 would leave that tier.
//
// Design (Hopper).  The query tile and the row tile are staged
// feature-contiguous, [r][e] with a pitch of KC + 4 floats (16-byte
// loads of 8 consecutive rows hit 8 distinct bank quads), KC = 16
// features a stage, through a 3-stage ring filled by 16-byte cp.async
// copies while the previous stages are multiplied (rows past n_end,
// queries past Q and features past D are zero-filled, never read).
// Thread (ty, tx) = (t / 16, t % 16) holds the BQ/16 × BN/16 outputs of
// queries ty + 16·a and rows tx + 16·b in registers: per 4 features it
// reads its queries and rows with one 16-byte shared load each (the
// shorter side held, the longer streamed) and runs them through its
// accumulators in order e, e+1, e+2, e+3 (at 128 × 64: 12 loads per 128
// FMAs).  ‖x‖² (threads t < BN) and ‖q‖² (the next BQ threads) are summed
// once per block from the same stages.  The labels ride in the first
// copy group: the first Wt ≤ W words of each label row (W is the rows'
// pitch), which the caller may cut to the last word that is nonzero in
// some query of the tile (a query word of zero passes every row).  The block's shared memory (Smem<BQ, BN>) is dynamic:
// callers opt in above 48 KB.
#pragma once

#include <stdint.h>

#include "scan_common.cuh"

namespace dense {

constexpr int kThreads = 256;
constexpr int KC = 16;        // features per stage
constexpr int LD = KC + 4;    // staged pitch (floats)
constexpr int kStages = 3;    // ring depth
constexpr int kMaxWords = 8;
constexpr int WP = kMaxWords + 1;  // label-word pitch

// A [BQ, BN] tile's shared memory: the ring, or in its place the finished
// tile (pitch BN + 16: thread (ty, tx)'s writes and a warp's row reads
// are conflict-free), then the labels and norms.
template <int BQ, int BN>
struct Smem {
  static constexpr int OUT_LD = BN + 16;
  union {
    // stage s: the query tile [BQ][LD], then the row tile [BN][LD]
    float ring[kStages][(BQ + BN) * LD];
    float d[BQ][OUT_LD];  // a finished tile, written by the callers
  } u;
  int lq[BQ][WP];
  int lx[BN][WP];
  float qn[BQ];
  float xn[BN];
};

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a.x, a.y, a.z or a.w
__device__ __forceinline__ float part(const float4& a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : (i == 2 ? a.z : a.w));
}

// Features [e0, e0 + KC) of the query tile (rows 0 .. BQ-1 of the stage)
// and of the row tile (rows BQ .. BQ+BN-1) into one ring stage.  vec:
// D % 4 == 0 and both bases 16-byte aligned (16-byte copies), else one
// 4-byte copy per feature.
template <int BQ, int BN>
__device__ __forceinline__ void stage(const float* __restrict__ q,
                                      const float* __restrict__ x, int Q,
                                      int n_end, int D, int q0, int n0,
                                      int e0, bool vec, float* buf) {
  const int t = threadIdx.x;
  if (vec) {
    constexpr int CPR = KC / 4;  // 16-byte copies a row
    for (int i = t; i < (BQ + BN) * CPR; i += kThreads) {
      const int r = i / CPR, e = e0 + 4 * (i % CPR);
      const bool isq = r < BQ;
      const long long g = isq ? q0 + r : n0 + r - BQ;
      const bool ok = (isq ? g < Q : g < n_end) && e < D;
      const float* base = isq ? q : x;
      cp_async16(buf + r * LD + (e - e0), ok ? base + g * D + e : base, ok);
    }
  } else {
    for (int i = t; i < (BQ + BN) * KC; i += kThreads) {
      const int r = i / KC, e = e0 + i % KC;
      const bool isq = r < BQ;
      const long long g = isq ? q0 + r : n0 + r - BQ;
      const bool ok = (isq ? g < Q : g < n_end) && e < D;
      const float* base = isq ? q : x;
      cp_async4(buf + r * LD + (e - e0), ok ? base + g * D + e : base, ok);
    }
  }
}

// The tile of queries [q0, q0 + BQ) ∩ [0, Q) against rows [n0, n0 + BN) ∩
// [0, n_end): d[a][b] holds query q0 + ty + 16·a against row n0 + tx + 16·b
// (+inf for rows past n_end; entries of queries past Q are never read).
// Label words [Wt, W) are not tested: they must be zero in every query of
// the tile (Wt = W tests them all).
// Every thread of the block must call it.  It synchronizes first of all,
// before it overwrites the shared buffers, and last, after the ring's
// last reader: a caller may write s.u.d as soon as it returns.
template <int BQ, int BN, bool L2>
__device__ __forceinline__ void tile(const float* __restrict__ q,
                                     const float* __restrict__ x,
                                     const int* __restrict__ lq,
                                     const int* __restrict__ lx, int Q,
                                     int n_end, int D, int W, int Wt, int q0,
                                     int n0, bool vec, Smem<BQ, BN>& s,
                                     float (&d)[BQ / 16][BN / 16]) {
  static_assert(BQ + BN <= kThreads, "a thread per row and query norm");
  constexpr int TQ = BQ / 16, TN = BN / 16;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int nk = (D + KC - 1) / KC;
  float acc[TQ][TN];
#pragma unroll
  for (int a = 0; a < TQ; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.0f;
  // t < BN: ‖x‖² of row n0 + t; BN <= t < BN + BQ: ‖q‖² of q0 + t - BN
  float norm = 0.0f;
  const int nrow = t < BN ? BQ + t : t - BN;  // its row in a stage

  __syncthreads();  // the previous user of s is done
  // the labels ride in the first group
  for (int i = t; i < BQ * Wt; i += kThreads) {
    const int r = i / Wt, w = i % Wt, qi = q0 + r;
    cp_async4(&s.lq[r][w], qi < Q ? lq + static_cast<long long>(qi) * W + w
                                  : lq, qi < Q);
  }
  for (int i = t; i < BN * Wt; i += kThreads) {
    const int r = i / Wt, w = i % Wt, n = n0 + r;
    cp_async4(&s.lx[r][w], n < n_end ? lx + static_cast<long long>(n) * W + w
                                     : lx, n < n_end);
  }
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nk)
      stage<BQ, BN>(q, x, Q, n_end, D, q0, n0, c * KC, vec, s.u.ring[c]);
    cp_async_commit();  // every thread commits a group per stage, even empty
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's have; chunk c − 1's readers are done
    const int nx = c + kStages - 1;
    if (nx < nk)
      stage<BQ, BN>(q, x, Q, n_end, D, q0, n0, nx * KC, vec,
                    s.u.ring[nx % kStages]);
    cp_async_commit();
    const float* qs = s.u.ring[c % kStages];
    const float* xs = qs + BQ * LD;
    if (L2 && t < BN + BQ) {
#pragma unroll
      for (int e = 0; e < KC; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(qs + nrow * LD + e);
        norm = __fmaf_rn(v.x, v.x, norm);
        norm = __fmaf_rn(v.y, v.y, norm);
        norm = __fmaf_rn(v.z, v.z, norm);
        norm = __fmaf_rn(v.w, v.w, norm);
      }
    }
    // one 4-feature group at a time (unrolling across groups costs the
    // registers that hold the blocks an SM, and spills); the shorter side
    // of the thread's tile is held in registers, the longer one streamed
#pragma unroll 1
    for (int e = 0; e < KC; e += 4) {
      if constexpr (TQ > TN) {
        float4 xa[TN];
#pragma unroll
        for (int b = 0; b < TN; ++b)
          xa[b] = *reinterpret_cast<const float4*>(xs + (tx + 16 * b) * LD + e);
#pragma unroll
        for (int a = 0; a < TQ; ++a) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * LD + e);
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int b = 0; b < TN; ++b)
              acc[a][b] = __fmaf_rn(part(qv, f), part(xa[b], f), acc[a][b]);
        }
      } else {
        float4 qa[TQ];
#pragma unroll
        for (int a = 0; a < TQ; ++a)
          qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * LD + e);
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (tx + 16 * b) * LD + e);
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int a = 0; a < TQ; ++a)
              acc[a][b] = __fmaf_rn(part(qa[a], f), part(xv, f), acc[a][b]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; none may stay in flight
  if (L2) {
    if (t < BN)
      s.xn[t] = norm;
    else if (t < BN + BQ)
      s.qn[t - BN] = norm;
  }
  __syncthreads();  // norms in; the ring is free for s.u.d

#pragma unroll
  for (int a = 0; a < TQ; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int c = tx + 16 * b;
      bool keep = n0 + c < n_end;
      for (int w = 0; w < Wt; ++w)
        keep = keep && ((s.lq[r][w] & s.lx[c][w]) == s.lq[r][w]);
      const float v =
          L2 ? scan::l2_norms_form(s.qn[r], acc[a][b], s.xn[c]) : -acc[a][b];
      d[a][b] = keep ? v : scan::inf();
    }
  }
}

// 16-byte copies need D % 4 == 0 and 16-byte aligned bases
__host__ __forceinline__ bool vec_ok(const void* a, const void* b, int D) {
  return D % 4 == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(b) % 16) == 0;
}

// opt a kernel in to `bytes` of dynamic shared memory (once per kernel)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace dense
