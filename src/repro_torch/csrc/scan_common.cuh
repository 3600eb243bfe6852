// Per-row arithmetic shared by the segmented scan kernels (sm_90a).
//
// One thread owns one (query, candidate row) pair and walks the feature
// axis in order, e = 0 .. D-1, with explicitly rounded operations
// (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into an
// FMA).  The accumulation order of a row's sum is therefore fixed by D
// alone: it does not depend on the query tile, the span split, the chunk
// or the batch size, which is what makes batched == looped hold bitwise
// inside the port (DESIGN.md §3.4 rule 1).  With ``vec`` set (D a multiple
// of 16 and a 16-byte aligned base, checked by the host wrapper) rows are
// read in groups of 16 elements with 16-byte loads; the groups are still
// summed element by element in order, so ``vec`` never changes a value.
#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

namespace scan {

enum Dtype { F32 = 0, F16 = 1, U8 = 2 };

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// acc + a·b with the product and the sum each rounded (never one FMA)
__device__ __forceinline__ float mac(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// the norms form of the l2 distance, (‖q‖² − 2·ip) + ‖x‖², rounded as the
// plain versions and the Pallas kernels evaluate it
__device__ __forceinline__ float l2_norms_form(float qn, float ip, float xn) {
  return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, ip)), xn);
}

// (value, position) order, values in IEEE total order (-0.0 before +0.0,
// as lax.top_k and the plain versions' stable sorts order them)
__device__ __forceinline__ int order_key(float v) {
  const int i = __float_as_int(v);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ bool key_less(float av, int ap, float bv, int bp) {
  const int ka = order_key(av), kb = order_key(bv);
  return ka < kb || (ka == kb && ap < bp);
}

// int8 dequant, rounded exactly as the eager upload-time value
// zeros + scales * codes (one multiply, then one add).
__device__ __forceinline__ float dequant(float code, float s, float z) {
  return __fadd_rn(z, __fmul_rn(s, code));
}

template <int DT>
__device__ __forceinline__ float load1(const void* row, int e, float s,
                                       float z) {
  if (DT == F32) return static_cast<const float*>(row)[e];
  if (DT == F16) return __half2float(static_cast<const __half*>(row)[e]);
  return dequant(static_cast<float>(static_cast<const uint8_t*>(row)[e]), s,
                 z);
}

// elements [16 g, 16 g + 16) of a row whose base is 16-byte aligned
template <int DT>
__device__ __forceinline__ void load16(const void* row, int g, float s,
                                       float z, float (&v)[16]) {
  if (DT == F32) {
    const float4* p = static_cast<const float4*>(row) + 4 * g;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 t = p[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if (DT == F16) {
    const uint4* p = static_cast<const uint4*>(row) + 2 * g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 t = p[i];
      const __half2* h = reinterpret_cast<const __half2*>(&t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __half22float2(h[j]);
        v[8 * i + 2 * j] = f.x;
        v[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else {
    uint4 t = static_cast<const uint4*>(row)[g];
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&t);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = dequant(static_cast<float>(b[i]), s, z);
  }
}

// DIRECT = false: the inner product sum_e q_e * x_e.
// DIRECT = true:  the direct squared distance sum_e (q_e - x_e)^2.
// qs is the query row (shared memory), row the candidate's storage row.
template <int DT, bool DIRECT>
__device__ __forceinline__ float row_sum(const float* qs, const void* row,
                                         int D, bool vec, float s, float z) {
  float acc = 0.0f;
  if (vec) {
    for (int g = 0; g < (D >> 4); ++g) {
      float v[16];
      load16<DT>(row, g, s, z, v);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float qe = qs[16 * g + i];
        if (DIRECT) {
          const float t = __fsub_rn(qe, v[i]);
          acc = __fadd_rn(acc, __fmul_rn(t, t));
        } else {
          acc = __fadd_rn(acc, __fmul_rn(v[i], qe));
        }
      }
    }
  } else {
    for (int e = 0; e < D; ++e) {
      const float x = load1<DT>(row, e, s, z);
      if (DIRECT) {
        const float t = __fsub_rn(qs[e], x);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      } else {
        acc = __fadd_rn(acc, __fmul_rn(x, qs[e]));
      }
    }
  }
  return acc;
}

__device__ __forceinline__ const void* row_ptr(const void* x, int DT,
                                               long long gid, int D) {
  const int item = DT == F32 ? 4 : (DT == F16 ? 2 : 1);
  return static_cast<const char*>(x) + gid * static_cast<long long>(D) * item;
}

// lq ⊆ lx word by word
__device__ __forceinline__ bool contains(const int* lq, const int* lx,
                                         int W) {
  bool ok = true;
  for (int w = 0; w < W; ++w) ok = ok && ((lq[w] & lx[w]) == lq[w]);
  return ok;
}

// tombstone bit of row gid (little bit order), true = alive
__device__ __forceinline__ bool alive(const uint8_t* tomb, long long gid) {
  return tomb == nullptr || ((tomb[gid >> 3] >> (gid & 7)) & 1) == 0;
}

}  // namespace scan
