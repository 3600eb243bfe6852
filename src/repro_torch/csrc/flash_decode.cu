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
//   * flash_decode_partial: one block of 128 threads per (S-split, KV
//     head, row) walks its split in tiles of 32 slots.  A ring of kStages
//     tiles of K and V lives in shared memory and is filled with cp.async
//     (16-byte copies that bypass L1), kStages − 1 tiles ahead of the tile
//     being consumed, so the copies of the next tiles are in flight while
//     the current one is computed.  Slots at or past the row's length are
//     zero-filled without a read.
//   * Per tile: (1) scores — lane j of warp w sums slot j's K row over the
//     w-th quarter of the head dimension against the G query heads held in
//     shared memory, and the quarters are added in order, so each (head,
//     slot) score is computed once; (2) softmax — warp w owns heads
//     w, w + 4, …: one max, one rescale of (m, l) per tile and head, the
//     weights as exp2 of log2(e)-scaled scores; (3) values — each thread
//     owns two dimensions of the head for a group of the tile's slots and
//     accumulates weight × V in f32 registers for all G heads.  Everything
//     stays on the CUDA cores in f32 (bf16 weights would leave the parity
//     tolerance).  The slot groups are added in order at the end into one
//     partial (m, l, acc[G, Dh]) in an f32 workspace.
//   * flash_decode_combine: one block per (query head, row) merges the
//     row's live splits in split order.
// The split length depends on S alone (the wrapper's split_len), never on
// B or on other rows' lengths, and no atomics are used: a row's output is
// bitwise the same at every batch size, and from run to run.  A split
// wholly at or past the length writes nothing and is not merged.
// A row with length ≤ 0 attends over every slot at score −1e30 (uniform
// weights), which is what the reference's masked softmax gives it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // slots per tile (one per lane in the softmax)
constexpr int kStages = 3;   // tiles in the shared-memory ring
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// the pieces of one block's shared memory, in bytes, for element type T
template <typename T, int DH, int MAXG>
struct Layout {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per copy
  static constexpr int CH = DH / VEC;            // 16-byte chunks per row
  static constexpr int ROW = DH * sizeof(T) + 16;  // padded: no conflicts
  static constexpr int STAGE = 2 * kTile * ROW;    // K tile, then V tile
  static constexpr int NPART = CH < kWarps ? CH : kWarps;  // score quarters
  static constexpr int CPP = CH / NPART;           // chunks per part
  static constexpr int NDP = DH / 2;               // dimension pairs
  static constexpr int NSG = kThreads / NDP;       // slot groups (values)
  static constexpr int SPG = kTile / NSG;          // slots per group
  static constexpr int HPW = (MAXG + kWarps - 1) / kWarps;  // heads a warp
  static constexpr int RING = kStages * STAGE;
  static constexpr int COMB = NSG * MAXG * DH * 4;  // group sums, at the end
  static constexpr int Q = (RING > COMB ? RING : COMB);  // q follows
  static constexpr int SC = Q + MAXG * DH * 4;          // scores [NPART][G][T]
  static constexpr int PW = SC + NPART * MAXG * kTile * 4;  // weights [G][T]
  static constexpr int CORR = PW + MAXG * kTile * 4;        // rescale [G]
  static constexpr int BYTES = CORR + MAXG * 4;
  static_assert(CH % NPART == 0 && NDP <= kThreads && kTile % NSG == 0,
                "head_dim");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool read) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = read ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of T in shared memory, widened to f32
__device__ __forceinline__ void widen(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
// two consecutive elements of T in shared memory, widened to f32
__device__ __forceinline__ float2 widen2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, int DH, int MAXG>
__global__ void __launch_bounds__(kThreads, 3) flash_decode_partial(
    const void* __restrict__ q, int q_bf16, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
    int S, int KH, int G, int split_len, int NS, float scale_log2) {
  using L = Layout<T, DH, MAXG>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::Q);        // [MAXG][DH]
  float* sc = reinterpret_cast<float*>(smem + L::SC);       // [NPART][MAXG][T]
  float* pw = reinterpret_cast<float*>(smem + L::PW);       // [MAXG][T]
  float* corr = reinterpret_cast<float*>(smem + L::CORR);   // [MAXG]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const bool none = len <= 0;
  const int lo = split * split_len;
  const int hi = min(lo + split_len, S);
  const int end = none ? hi : min(hi, len);
  if (lo >= end) return;  // wholly at or past the length: contributes nothing
  const int tiles = (end - lo + kTile - 1) / kTile;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long slot_stride = static_cast<long long>(KH) * DH;
  const T* kb = k + (static_cast<long long>(b) * S * KH + h) * DH;
  const T* vb = v + (static_cast<long long>(b) * S * KH + h) * DH;

  // copy tile `tile` into ring stage `stage`; slots at or past `end` are
  // zero-filled and never read
  auto issue = [&](int tile, int stage) {
    unsigned char* dst = smem + stage * L::STAGE;
    const int t0 = lo + tile * kTile;
    for (int i = tid; i < 2 * kTile * L::CH; i += kThreads) {
      const int kv = i / (kTile * L::CH), r = i % (kTile * L::CH);
      const int s = r / L::CH, c = r % L::CH;
      const bool live = t0 + s < end;
      const T* src = (kv ? vb : kb) + (live ? t0 + s : lo) * slot_stride +
                     c * L::VEC;
      cp_async16(dst + (kv * kTile + s) * L::ROW + c * 16, src, live);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) issue(s, s);
    cp_async_commit();  // every thread commits a group per stage, even empty
  }

  const int H = KH * G;
  for (int i = tid; i < MAXG * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float x = 0.0f;
    if (g < G) {
      const long long o =
          (static_cast<long long>(b) * H + static_cast<long long>(h) * G + g) *
              DH + d;
      x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[o])
                 : static_cast<const float*>(q)[o];
    }
    qs[i] = x;
  }

  // the softmax state of the heads this warp owns (g = warp + kWarps·i),
  // the same in every lane
  float m[L::HPW], l[L::HPW];
#pragma unroll
  for (int i = 0; i < L::HPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  // values: dimensions 2·dp, 2·dp + 1 over the slots of group grp
  const int dp = tid % L::NDP, grp = tid / L::NDP;
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.0f;

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` landed
    __syncthreads();  // everyone's; and the stage refilled below is consumed
    if (tile + kStages - 1 < tiles)
      issue(tile + kStages - 1, (tile + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* st = smem + (tile % kStages) * L::STAGE;
    const T* kt = reinterpret_cast<const T*>(st);
    const T* vt = reinterpret_cast<const T*>(st + kTile * L::ROW);
    const int t0 = lo + tile * kTile;

    // (1) partial scores: lane = slot, warp = part of the head dimension
    if (warp < L::NPART) {
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) s[g] = 0.0f;
      const T* row = reinterpret_cast<const T*>(
          reinterpret_cast<const unsigned char*>(kt) + lane * L::ROW);
#pragma unroll
      for (int c = 0; c < L::CPP; ++c) {
        const int e0 = (warp * L::CPP + c) * L::VEC;
        float kf[L::VEC];
        widen(row + e0, kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) continue;
#pragma unroll
          for (int e = 0; e < L::VEC; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + g * DH + e0 + e);
            s[g] = fmaf(qv.x, kf[e], s[g]);
            s[g] = fmaf(qv.y, kf[e + 1], s[g]);
            s[g] = fmaf(qv.z, kf[e + 2], s[g]);
            s[g] = fmaf(qv.w, kf[e + 3], s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sc[(warp * MAXG + g) * kTile + lane] = s[g];
    }
    __syncthreads();

    // (2) softmax: warp owns heads warp + kWarps·i, lane = slot
#pragma unroll
    for (int i = 0; i < L::HPW; ++i) {
      const int g = warp + kWarps * i;
      if (g >= G) continue;  // warp-uniform
      float x = 0.0f;
#pragma unroll
      for (int p = 0; p < L::NPART; ++p) x += sc[(p * MAXG + g) * kTile + lane];
      const bool live = t0 + lane < end;
      x = !live ? -INFINITY : (none ? kMasked : x * scale_log2);
      const float mn = fmaxf(m[i], warp_max(x));  // finite: slot t0 is live
      const float c = exp2f(m[i] - mn);           // m = −inf: 0
      const float p = live ? exp2f(x - mn) : 0.0f;
      l[i] = l[i] * c + warp_sum(p);
      m[i] = mn;
      pw[g * kTile + lane] = p;
      if (lane == 0) corr[g] = c;
    }
    __syncthreads();

    // (3) values: acc = acc·c + Σ_slots p·V, slots of this group in order
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      const float c = corr[g];
      acc[g][0] *= c;
      acc[g][1] *= c;
    }
#pragma unroll 4
    for (int j = 0; j < L::SPG; ++j) {
      const int s = grp * L::SPG + j;
      const float2 vv = widen2(reinterpret_cast<const T*>(
          reinterpret_cast<const unsigned char*>(vt) + s * L::ROW) + 2 * dp);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) continue;
        const float p = pw[g * kTile + s];
        acc[g][0] = fmaf(p, vv.x, acc[g][0]);
        acc[g][1] = fmaf(p, vv.y, acc[g][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the group sums reuse it

  float* comb = reinterpret_cast<float*>(smem);  // [NSG][MAXG][DH]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) continue;
    comb[(grp * MAXG + g) * DH + 2 * dp] = acc[g][0];
    comb[(grp * MAXG + g) * DH + 2 * dp + 1] = acc[g][1];
  }
  const long long p0 =
      ((static_cast<long long>(b) * KH + h) * NS + split) * G;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < L::HPW; ++i) {
      const int g = warp + kWarps * i;
      if (g >= G) continue;
      pm[p0 + g] = m[i];
      pl[p0 + g] = l[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float a = 0.0f;
#pragma unroll
    for (int r = 0; r < L::NSG; ++r) a += comb[(r * MAXG + g) * DH + d];
    pacc[(p0 + g) * DH + d] = a;
  }
}

// one block per (query head, row), one thread per head element: the row's
// live splits merged in split order (m in log2 units)
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
    const float wt = exp2f(pm[o] - M);
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
                           int NS, float scale_log2) {
  constexpr int bytes = Layout<T, DH, MAXG>::BYTES;
  static bool opted_in = false;  // the attribute is per function
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_partial<T, DH, MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  flash_decode_partial<T, DH, MAXG><<<grid, kThreads, bytes, st>>>(
      q, q_bf16, static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      pm, pl, pacc, S, KH, G, split_len, NS, scale_log2);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_g(dim3 grid, cudaStream_t st, const void* q, int q_bf16,
                       const void* k, const void* v, const int* lengths,
                       float* pm, float* pl, float* pacc, int S, int KH,
                       int G, int split_len, int NS, float scale_log2) {
#define FD_G(MG)                                                            \
  return launch_partial<T, DH, MG>(grid, st, q, q_bf16, k, v, lengths, pm, \
                                   pl, pacc, S, KH, G, split_len, NS,      \
                                   scale_log2)
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
                        float scale_log2) {
#define FD_DH(D)                                                             \
  return dispatch_g<T, D>(grid, st, q, q_bf16, k, v, lengths, pm, pl, pacc, \
                          S, KH, G, split_len, NS, scale_log2)
  if (Dh == 16) FD_DH(16);
  if (Dh == 32) FD_DH(32);
  if (Dh == 64) FD_DH(64);
  FD_DH(128);
#undef FD_DH
}

template <typename T, int DH>
int smem_bytes_g(int G) {
  if (G <= 1) return Layout<T, DH, 1>::BYTES;
  if (G <= 2) return Layout<T, DH, 2>::BYTES;
  if (G <= 4) return Layout<T, DH, 4>::BYTES;
  if (G <= 8) return Layout<T, DH, 8>::BYTES;
  return Layout<T, DH, 16>::BYTES;
}

template <typename T>
int smem_bytes_dh(int Dh, int G) {
  if (Dh == 16) return smem_bytes_g<T, 16>(G);
  if (Dh == 32) return smem_bytes_g<T, 32>(G);
  if (Dh == 64) return smem_bytes_g<T, 64>(G);
  return smem_bytes_g<T, 128>(G);
}

}  // namespace

// dynamic shared memory of one flash_decode_partial block
extern "C" int flash_decode_smem_bytes(int kv_bf16, int Dh, int G) {
  return kv_bf16 ? smem_bytes_dh<__nv_bfloat16>(Dh, G)
                 : smem_bytes_dh<float>(Dh, G);
}

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
  const float sl2 = scale * kLog2e;
  cudaError_t err =
      kv_bf16 ? dispatch_dh<__nv_bfloat16>(grid, st, Dh, q, q_bf16, k, v,
                                           lengths, pm, pl, pacc, S, KH, G,
                                           split_len, NS, sl2)
              : dispatch_dh<float>(grid, st, Dh, q, q_bf16, k, v, lengths,
                                   pm, pl, pacc, S, KH, G, split_len, NS,
                                   sl2);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine<<<dim3(KH * G, B), Dh, 0, st>>>(
      pm, pl, pacc, lengths, out, out_bf16, KH, G, Dh, split_len, NS);
  return static_cast<int>(cudaGetLastError());
}
