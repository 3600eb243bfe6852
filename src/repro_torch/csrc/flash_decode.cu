// Split-K flash-decoding attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_decode.py::flash_decode_pallas (the
// Pallas TPU kernel whose grid (B, S / block_s) walks each row's cache in
// order, carrying the online-softmax state (m, l, acc) in VMEM scratch).
//
// One-token GQA decode attention: H = KH·G query heads, the G heads of KV
// head h attending over K, V [B, S, KH, Dh] with per-row lengths:
//
//   s   = q·Kᵀ / √Dh, slots at or past lengths[b] masked (−1e30);
//   out = softmax(s)·V, with (m, l, acc) in f32, out = acc / max(l, 1e−30)
//   in q's dtype.
//
// Bound on the card.  Each (row, KV head) reads its S·Dh K and V elements
// once for 4·G·Dh flops per slot (G ≤ 16): well under the ridge point, so
// the bound is bytes, K and V read once.
//
// Design.  Blocks run in parallel and in no order, so the TPU kernel's
// in-order walk over S becomes split-K:
//   * flash_decode_partial: one block per (S-split, KV head, row).  It
//     stages the G query heads of its KV head once in shared memory and
//     streams its split's K and V rows with 16-byte loads (a "lane group"
//     of Dh·sizeof(T)/16 lanes holds one slot's row), accumulating an
//     online softmax in f32 registers per lane group; the groups merge
//     through warp shuffles and then shared memory into one partial
//     (m, l, acc[G, Dh]) in an f32 workspace.  Slots at or past the row's
//     length are never read, and a split wholly past it writes nothing.
//   * flash_decode_combine: one block per (query head, row) merges the
//     row's live splits in split order.
// The split length depends on S alone (the wrapper's split_len), never on
// B or on other rows' lengths, and no atomics are used: a row's output is
// bitwise the same at every batch size, and from run to run.
// A row with length ≤ 0 attends over every slot at score −1e30 (uniform
// weights), which is what the reference's masked softmax gives it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

// one 16-byte load of T, widened to f32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// weight of a partial with running max m inside a merge whose max is M;
// an empty partial (m = −inf) weighs 0, also when M is −inf
__device__ __forceinline__ float merge_weight(float m, float M) {
  return m == -INFINITY ? 0.0f : expf(m - M);
}

template <typename T, int DH, int MAXG>
__global__ void __launch_bounds__(kThreads) flash_decode_partial(
    const void* __restrict__ q, int q_bf16, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
    int S, int KH, int G, int split_len, int NS, float scale) {
  constexpr int VEC = Vec16<T>::N;     // elements per lane and load
  constexpr int LPS = DH / VEC;        // lanes holding one slot's row
  constexpr int SPW = 32 / LPS;        // slots a warp holds at once
  constexpr int NG = kWarps * SPW;     // lane groups of the block
  constexpr int U = MAXG <= 4 ? 4 : 2; // slots per lane group per pass
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "head_dim");

  __shared__ float qs[MAXG][DH];
  __shared__ float sm_m[kWarps][MAXG];
  __shared__ float sm_l[kWarps][MAXG];
  __shared__ float sm_acc[kWarps][MAXG][DH];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const bool none = len <= 0;
  const int lo = split * split_len;
  const int hi = min(lo + split_len, S);
  const int end = none ? hi : min(hi, len);
  if (lo >= end) return;  // wholly at or past the length: contributes nothing

  const int H = KH * G;
  for (int i = threadIdx.x; i < MAXG * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float x = 0.0f;
    if (g < G) {
      const long long o =
          (static_cast<long long>(b) * H + static_cast<long long>(h) * G + g) *
              DH + d;
      x = q_bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(q)[o])
                 : static_cast<const float*>(q)[o];
    }
    qs[g][d] = x;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = (lane % LPS) * VEC;
  const int grp = warp * SPW + lane / LPS;
  const long long row = static_cast<long long>(KH) * DH;  // slot stride
  const long long head0 =
      (static_cast<long long>(b) * S * KH + h) * DH + d0;
  const T* kb = k + head0;
  const T* vb = v + head0;

  float m[MAXG], l[MAXG], acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  }

  // every lane runs the same number of passes (the shuffles need the
  // whole warp); a slot at or past ``end`` is neither read nor counted
  for (int pass = lo; pass < end; pass += NG * U) {
    const int base = pass + grp * U;
    float kr[U][VEC], vr[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      if (t < end) {
        Vec16<T>::load(kb + t * row, kr[u]);
        Vec16<T>::load(vb + t * row, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[u][e] = vr[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float x = 0.0f;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) x = fmaf(qs[g][d0 + e], kr[u][e], x);
        }
        s[g] = x;
      }
#pragma unroll
      for (int off = LPS / 2; off > 0; off /= 2) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      }
      if (base + u < end) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) continue;
          const float x = none ? kMasked : s[g] * scale;
          const float mn = fmaxf(m[g], x);
          const float c = expf(m[g] - mn);  // m = −inf: 0
          const float p = expf(x - mn);
          l[g] = l[g] * c + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = fmaf(acc[g][e], c, p * vr[u][e]);
          m[g] = mn;
        }
      }
    }
  }

  // merge the warp's lane groups (lanes LPS apart hold the same slice)
#pragma unroll
  for (int off = LPS; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float a = merge_weight(m[g], M), c = merge_weight(mo, M);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = M;
    }
  }
  if (lane < LPS) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps, in warp order, into this split's partial
  const long long p0 =
      ((static_cast<long long>(b) * KH + h) * NS + split) * G;
  for (int i = threadIdx.x; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float a = 0.0f, L = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = merge_weight(sm_m[w][g], M);
      a += sm_acc[w][g][d] * wt;
      L += sm_l[w][g] * wt;
    }
    pacc[(p0 + g) * DH + d] = a;
    if (d == 0) {
      pm[p0 + g] = M;
      pl[p0 + g] = L;
    }
  }
}

// one block per (query head, row), one thread per head element: the row's
// live splits merged in split order
__global__ void flash_decode_combine(const float* __restrict__ pm,
                                     const float* __restrict__ pl,
                                     const float* __restrict__ pacc,
                                     const int* __restrict__ lengths,
                                     void* __restrict__ out, int out_bf16,
                                     int KH, int G, int DH, int split_len,
                                     int NS) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int h = hq / G, g = hq % G;
  const long long len = lengths[b];
  const int live =
      len <= 0 ? NS
               : static_cast<int>(min(static_cast<long long>(NS),
                                      (len + split_len - 1) / split_len));
  const long long base = (static_cast<long long>(b) * KH + h) * NS;
  float M = -INFINITY;
  for (int j = 0; j < live; ++j) M = fmaxf(M, pm[(base + j) * G + g]);
  float a = 0.0f, L = 0.0f;
  for (int j = 0; j < live; ++j) {
    const long long o = (base + j) * G + g;
    const float wt = expf(pm[o] - M);
    L += pl[o] * wt;
    a += pacc[o * DH + d] * wt;
  }
  const float r = a / fmaxf(L, 1e-30f);
  const long long oo =
      (static_cast<long long>(b) * KH * G + hq) * DH + d;
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[oo] = __float2bfloat16(r);
  else
    static_cast<float*>(out)[oo] = r;
}

template <typename T, int DH, int MAXG>
cudaError_t launch_partial(dim3 grid, cudaStream_t st, const void* q,
                           int q_bf16, const void* k, const void* v,
                           const int* lengths, float* pm, float* pl,
                           float* pacc, int S, int KH, int G, int split_len,
                           int NS, float scale) {
  flash_decode_partial<T, DH, MAXG><<<grid, kThreads, 0, st>>>(
      q, q_bf16, static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      pm, pl, pacc, S, KH, G, split_len, NS, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_g(dim3 grid, cudaStream_t st, const void* q, int q_bf16,
                       const void* k, const void* v, const int* lengths,
                       float* pm, float* pl, float* pacc, int S, int KH,
                       int G, int split_len, int NS, float scale) {
#define FD_G(MG)                                                            \
  return launch_partial<T, DH, MG>(grid, st, q, q_bf16, k, v, lengths, pm, \
                                   pl, pacc, S, KH, G, split_len, NS, scale)
  if (G <= 1) FD_G(1);
  if (G <= 2) FD_G(2);
  if (G <= 4) FD_G(4);
  if (G <= 8) FD_G(8);
  FD_G(16);
#undef FD_G
}

template <typename T>
cudaError_t dispatch_dh(dim3 grid, cudaStream_t st, int Dh, const void* q,
                        int q_bf16, const void* k, const void* v,
                        const int* lengths, float* pm, float* pl, float* pacc,
                        int S, int KH, int G, int split_len, int NS,
                        float scale) {
#define FD_DH(D)                                                             \
  return dispatch_g<T, D>(grid, st, q, q_bf16, k, v, lengths, pm, pl, pacc, \
                          S, KH, G, split_len, NS, scale)
  if (Dh == 16) FD_DH(16);
  if (Dh == 32) FD_DH(32);
  if (Dh == 64) FD_DH(64);
  FD_DH(128);
#undef FD_DH
}

}  // namespace

// q [B, KH·G, Dh] f32 or bf16 (q_bf16); k, v [B, S, KH, Dh] f32 or bf16
// (kv_bf16), 16-byte aligned; lengths [B] i32; workspace pm, pl
// [B, KH, NS, G] and pacc [B, KH, NS, G, Dh] f32; out [B, KH·G, Dh] f32 or
// bf16 (out_bf16).  Dh ∈ {16, 32, 64, 128}, 1 ≤ G ≤ 16,
// NS = ⌈S / split_len⌉.  Returns cudaGetLastError().
extern "C" int flash_decode(const void* q, int q_bf16, const void* k,
                            const void* v, int kv_bf16, const int* lengths,
                            float* pm, float* pl, float* pacc, void* out,
                            int out_bf16, int B, int S, int KH, int G, int Dh,
                            int split_len, int NS, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(NS, KH, B);
  cudaError_t err =
      kv_bf16 ? dispatch_dh<__nv_bfloat16>(grid, st, Dh, q, q_bf16, k, v,
                                           lengths, pm, pl, pacc, S, KH, G,
                                           split_len, NS, scale)
              : dispatch_dh<float>(grid, st, Dh, q, q_bf16, k, v, lengths,
                                   pm, pl, pacc, S, KH, G, split_len, NS,
                                   scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine<<<dim3(KH * G, B), Dh, 0, st>>>(
      pm, pl, pacc, lengths, out, out_bf16, KH, G, Dh, split_len, NS);
  return static_cast<int>(cudaGetLastError());
}
