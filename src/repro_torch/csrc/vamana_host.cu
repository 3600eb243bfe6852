// The Vamana build's reverse-edge pass, compiled host code (no device code).
//
// Port of the reverse-edge loop of src/repro/index/graph.py::build_vamana.
// For i = 0 .. n-1 in order, for each forward neighbour j of i: if i is not
// yet a neighbour of j, append it while j has fewer than M neighbours, else
// replace j's list by the α-robust prune of (j's list, i).  Node i reads its
// own list at step i, after every earlier step has edited it, so the pass is
// sequential: it runs on the host, and a compiled loop takes the place of
// the reference's Python one.
//
// Arithmetic.  Every distance is numpy's float32 pairwise summation of
// (a_e - b_e)^2 (eight running lanes for up to 128 features, halves above),
// the order of np.sum(..., axis=1) in the reference's _robust_prune, and
// α·d is one float32 multiply: the pass reproduces the plain numpy pass bit
// for bit.  Built with -ffp-contract=off, so no product is fused into a sum.
//
// Cost.  A node is pruned about twelve times (D = 128, M = 16), each time
// over its M neighbours plus the new one.  Each node keeps the distances
// among its last prune's kept neighbours and from itself to them, so a
// prune computes only the pairs with the new candidate: about M + 1
// distances instead of (M + 1)·(M + 2).
#include <algorithm>
#include <vector>

namespace {

// numpy's pairwise_sum (loops_utils.h.src) of (a_e - b_e)^2, e < n
float pairwise(const float* a, const float* b, int n) {
  if (n < 8) {
    float r = 0.0f;
    for (int e = 0; e < n; ++e) {
      const float t = a[e] - b[e];
      r += t * t;
    }
    return r;
  }
  if (n <= 128) {
    float r[8];
    for (int j = 0; j < 8; ++j) {
      const float t = a[j] - b[j];
      r[j] = t * t;
    }
    int i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) {
        const float t = a[i + j] - b[i + j];
        r[j] += t * t;
      }
    float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) {
      const float t = a[i] - b[i];
      res += t * t;
    }
    return res;
  }
  int n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise(a, b, n2) + pairwise(a + n2, b + n2, n - n2);
}

constexpr float kUnknown = -1.0f;   // distances are >= 0

struct Pass {
  const float* x;
  int D, M, K;                 // K = M + 1 candidates at most
  float alpha;
  // per node: the ids of its last prune's kept list, the distances from the
  // node to them and among them (kUnknown where not computed)
  std::vector<int> ids;        // [n, K]
  std::vector<float> to;       // [n, K]
  std::vector<float> among;    // [n, K, K]

  float dist(long long a, long long b) const {
    return pairwise(x + b * D, x + a * D, D);
  }

  // α-robust prune of node j over cand[0..m): writes the kept ids to out
  // and returns their count (the reference's _robust_prune)
  int prune(long long j, const int* cand_in, int m, int* out) {
    int cand[64];
    int c = 0;
    for (int t = 0; t < m; ++t) {            // drop j, keep first copies
      const int v = cand_in[t];
      if (v == j) continue;
      bool seen = false;
      for (int s = 0; s < c; ++s) seen = seen || cand[s] == v;
      if (!seen) cand[c++] = v;
    }
    if (c == 0) return 0;
    const int* cid = &ids[j * K];
    int slot[64];
    for (int t = 0; t < c; ++t) {
      slot[t] = -1;
      for (int s = 0; s < K; ++s)
        if (cid[s] == cand[t]) slot[t] = s;
    }
    float di[64];
    for (int t = 0; t < c; ++t) {
      const float v = slot[t] >= 0 ? to[j * K + slot[t]] : kUnknown;
      di[t] = v != kUnknown ? v : dist(j, cand[t]);
    }
    int order[64];
    for (int t = 0; t < c; ++t) order[t] = t;
    std::stable_sort(order, order + c,
                     [&](int a, int b) { return di[a] < di[b]; });
    int sc[64], ss[64];
    float sd[64];
    for (int t = 0; t < c; ++t) {
      sc[t] = cand[order[t]];
      ss[t] = slot[order[t]];
      sd[t] = di[order[t]];
    }
    // local pair matrix, seeded from the node's cache
    float L[64][64];
    const float* cam = &among[j * K * K];
    for (int a = 0; a < c; ++a)
      for (int b = 0; b < c; ++b)
        L[a][b] = (ss[a] >= 0 && ss[b] >= 0) ? cam[ss[a] * K + ss[b]]
                                             : kUnknown;
    bool alive[64];
    for (int t = 0; t < c; ++t) alive[t] = true;
    int kept[64];
    int nk = 0;
    for (int a = 0; a < c; ++a) {
      if (!alive[a]) continue;
      kept[nk++] = a;
      if (nk == M) break;
      for (int b = 0; b < c; ++b) {
        if (!alive[b]) continue;           // a dead candidate stays dead
        if (L[a][b] == kUnknown) {
          L[a][b] = dist(sc[a], sc[b]);
          L[b][a] = L[a][b];
        }
        if (alpha * L[a][b] <= sd[b]) alive[b] = false;
      }
      alive[a] = false;
    }
    // the node's new cache: its kept list (L already holds the old one)
    int* nid = &ids[j * K];
    float* nto = &to[j * K];
    float* nam = &among[j * K * K];
    for (int s = 0; s < K; ++s) {
      nid[s] = s < nk ? sc[kept[s]] : -1;
      nto[s] = s < nk ? sd[kept[s]] : kUnknown;
      for (int u = 0; u < K; ++u)
        nam[s * K + u] = s < nk && u < nk ? L[kept[s]][kept[u]] : kUnknown;
    }
    for (int s = 0; s < nk; ++s) out[s] = sc[kept[s]];
    return nk;
  }
};

}  // namespace

// x [n, D] f32; adj [n, M] i32 (-1 pad) and deg [n] i32, the forward
// lists, edited in place.  Returns 0, or 1 if M is out of range (M + 1
// candidates must fit the prune's 64-entry scratch).
extern "C" int vamana_reverse(const float* x, long long n, int D, int* adj,
                              int* deg, int M, float alpha) {
  if (M < 1 || M > 63) return 1;
  Pass p{x, D, M, M + 1, alpha, {}, {}, {}};
  const size_t K = static_cast<size_t>(M) + 1;
  p.ids.assign(static_cast<size_t>(n) * K, -1);
  p.to.assign(static_cast<size_t>(n) * K, kUnknown);
  p.among.assign(static_cast<size_t>(n) * K * K, kUnknown);
  int cand[64], kept[64], nb[64];
  for (long long i = 0; i < n; ++i) {
    const int di = deg[i];
    for (int t = 0; t < di; ++t) nb[t] = adj[i * M + t];
    for (int t = 0; t < di; ++t) {
      const long long j = nb[t];
      int* aj = adj + j * M;
      bool present = false;
      for (int s = 0; s < deg[j]; ++s) present = present || aj[s] == i;
      if (present) continue;
      if (deg[j] < M) {
        aj[deg[j]++] = static_cast<int>(i);
        continue;
      }
      for (int s = 0; s < deg[j]; ++s) cand[s] = aj[s];
      cand[deg[j]] = static_cast<int>(i);
      const int nk = p.prune(j, cand, deg[j] + 1, kept);
      for (int s = 0; s < M; ++s) aj[s] = s < nk ? kept[s] : -1;
      deg[j] = nk;
    }
  }
  return 0;
}
