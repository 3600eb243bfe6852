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
// with ip = Σ_e q_i[e]·x_j[e].  The query tile and the row tile are staged
// in shared memory KC features at a time; thread (ty, tx) = (t / 16, t % 16)
// holds the BQ/16 × 8 outputs of queries ty + 16·a and rows tx + 16·b in
// registers (a register-tiled product on the CUDA cores).  Every output's
// inner product, and every ‖q‖² and ‖x‖², is summed in order e = 0 .. D-1
// with scan::mac (rounded multiply, rounded add, no FMA), so a value depends
// on its two rows alone: not on Q, the Q-bucket, the tile, the span split or
// the grid.  That is what holds batched == looped on the card.  No tensor
// cores: TF32 would leave the parity tier (integer data bitwise, random
// data rtol 1e-5 against the plain torch versions).
#pragma once

#include "scan_common.cuh"

namespace dense {

constexpr int kThreads = 256;
constexpr int BN = 128;  // rows per tile
constexpr int KC = 32;   // features staged per step
constexpr int TN = BN / 16;
constexpr int kMaxWords = 8;

template <int BQ>
struct Smem {
  union {
    struct {
      float q[KC][BQ + 1];  // +1: conflict-free column writes
      float x[KC][BN + 1];
    } stage;
    float d[BQ][BN + 1];  // filtered_topk: the finished tile
  } u;
  int lq[BQ][kMaxWords];
  int lx[BN][kMaxWords];
  float qn[BQ];
  float xn[BN];
};

// The tile of queries [q0, q0 + BQ) ∩ [0, Q) against rows [n0, n0 + BN) ∩
// [0, n_end): d[a][b] holds query q0 + ty + 16·a against row n0 + tx + 16·b
// (+inf for rows past n_end; entries of queries past Q are never read).
// Every thread of the block must call it: it synchronizes, first of all
// before it overwrites the shared buffers.
template <int BQ, bool L2>
__device__ __forceinline__ void tile(const float* __restrict__ q,
                                     const float* __restrict__ x,
                                     const int* __restrict__ lq,
                                     const int* __restrict__ lx, int Q,
                                     int n_end, int D, int W, int q0, int n0,
                                     Smem<BQ>& s, float (&d)[BQ / 16][TN]) {
  constexpr int TQ = BQ / 16;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  float acc[TQ][TN];
#pragma unroll
  for (int a = 0; a < TQ; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.0f;
  float norm = 0.0f;  // t < BN: ‖x‖² of row n0 + t; then ‖q‖² of q0 + t - BN

  for (int e0 = 0; e0 < D; e0 += KC) {
    const int kc = min(KC, D - e0);
    __syncthreads();  // the previous chunk (or tile) is consumed
    for (int i = t; i < BQ * KC; i += kThreads) {
      const int r = i / KC, e = i % KC, qi = q0 + r;
      s.u.stage.q[e][r] =
          (qi < Q && e < kc) ? q[static_cast<long long>(qi) * D + e0 + e]
                             : 0.0f;
    }
    for (int i = t; i < BN * KC; i += kThreads) {
      const int r = i / KC, e = i % KC, n = n0 + r;
      s.u.stage.x[e][r] =
          (n < n_end && e < kc) ? x[static_cast<long long>(n) * D + e0 + e]
                                : 0.0f;
    }
    __syncthreads();
    if (L2) {
      if (t < BN) {
        for (int e = 0; e < kc; ++e)
          norm = scan::mac(norm, s.u.stage.x[e][t], s.u.stage.x[e][t]);
      } else if (t < BN + BQ) {
        for (int e = 0; e < kc; ++e)
          norm = scan::mac(norm, s.u.stage.q[e][t - BN],
                           s.u.stage.q[e][t - BN]);
      }
    }
    for (int e = 0; e < kc; ++e) {
      float qa[TQ], xb[TN];
#pragma unroll
      for (int a = 0; a < TQ; ++a) qa[a] = s.u.stage.q[e][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < TN; ++b) xb[b] = s.u.stage.x[e][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < TQ; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[a][b] = scan::mac(acc[a][b], qa[a], xb[b]);
    }
  }

  // label words and norms of the tile (outside the union: no sync needed
  // against the last chunk's readers)
  for (int i = t; i < BQ * W; i += kThreads) {
    const int r = i / W, w = i % W, qi = q0 + r;
    s.lq[r][w] = qi < Q ? lq[static_cast<long long>(qi) * W + w] : 0;
  }
  for (int i = t; i < BN * W; i += kThreads) {
    const int r = i / W, w = i % W, n = n0 + r;
    s.lx[r][w] = n < n_end ? lx[static_cast<long long>(n) * W + w] : 0;
  }
  if (L2) {
    if (t < BN)
      s.xn[t] = norm;
    else if (t < BN + BQ)
      s.qn[t - BN] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < TQ; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int c = tx + 16 * b;
      bool keep = n0 + c < n_end;
      for (int w = 0; w < W; ++w)
        keep = keep && ((s.lq[r][w] & s.lx[c][w]) == s.lq[r][w]);
      const float v =
          L2 ? scan::l2_norms_form(s.qn[r], acc[a][b], s.xn[c]) : -acc[a][b];
      d[a][b] = keep ? v : scan::inf();
    }
  }
}

}  // namespace dense
