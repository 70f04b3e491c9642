// Tile arithmetic shared by the full-context flash kernels
// (flash_attention.cu) and the banded kernel (banded_attention.cu): one
// block of 256 threads owns a 64-row query tile; its partner tiles are
// staged in shared memory as float32, rows padded by 4 floats so that the
// 16-byte loads of neighbouring rows fall in distinct banks. Thread
// (ty, tx) of the 16 x 16 grid computes the 4 x 4 score entries of rows
// 4 ty + i and columns tx + 16 j, so a row's 64 scores live in one
// half-warp and its max and sum are two shuffle reductions; the score
// tile goes through shared memory (rows padded to 68) to the second
// product, where the thread owns 4 rows and Dh / 16 output columns in
// registers. The head dim is a compile-time tile DM in {32, 64, 128}.
// Exact float32 FMA arithmetic; bfloat16 is widened as it is staged, and
// the probabilities (and score gradients) meet the second product rounded
// to bfloat16, as the TPU kernels' `p.astype(v.dtype)` feeds them (C6).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;       // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLDP = kTile + 4; // padded row of a score tile in smem
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// An operand of a second product (p before P·V, dS before dS·K) as the
// TPU kernels feed it: rounded to the input type, so in bfloat16 through
// bfloat16 and in float32 unchanged (the float32 kernels compile to the
// same code as without it).
template <typename T>
__device__ __forceinline__ float operand(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16(x));
  else
    return x;
}

// Geometry of head-dim tile DM: padded smem row LD; a thread's NO = DM / 16
// output columns in CH chunks of VEC neighbours, chunk j holding columns
// 16 VEC j + VEC tx + e.
template <int DM>
struct Geo {
  static constexpr int LD = DM + 4;
  static constexpr int VEC = DM >= 64 ? 4 : 2;
  static constexpr int CH = DM / (16 * VEC);
  static constexpr int NO = VEC * CH;
};

__device__ __forceinline__ int tx_() { return threadIdx.x & 15; }
__device__ __forceinline__ int ty_() { return threadIdx.x >> 4; }

// max / sum over the 16 lanes of a half-warp (the lanes of one ty)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows r0 .. r0 + 63 of an [n, Dh] matrix whose rows lie `stride`
// elements apart as float32 into dst (row stride LD); rows past n and
// columns past Dh are zeros.
template <typename T, int DM>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int r0,
                                          int n, int Dh, size_t stride) {
  constexpr int LD = Geo<DM>::LD;
  for (int i = threadIdx.x; i < kTile * DM; i += kThreads) {
    const int r = i / DM, c = i - r * DM;
    const int gr = r0 + r;
    float x = 0.f;
    if (gr < n && c < Dh) x = to_f32(src[(size_t)gr * stride + c]);
    dst[r * LD + c] = x;
  }
}

// s[i][j] = A[4 ty + i] . B[tx + 16 j] over DM columns (A, B row stride LD).
template <int DM>
__device__ __forceinline__ void dot_tile(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         float (&s)[4][4]) {
  constexpr int LD = Geo<DM>::LD;
  const int tx = tx_(), ty = ty_();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DM; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[VEC]);
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float (&out)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float (&out)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  out[0] = x.x; out[1] = x.y;
}

// acc[i][c] += sum_k P[4 ty + i][k] * V[k][col(c)] over the 64 rows of V
// (P row stride kLDP, V row stride LD).
template <int DM>
__device__ __forceinline__ void pv_tile(const float* __restrict__ P,
                                        const float* __restrict__ V,
                                        float (&acc)[4][Geo<DM>::NO]) {
  using G = Geo<DM>;
  const int tx = tx_(), ty = ty_();
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * kLDP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < G::CH; ++j) {
        float v[G::VEC];
        load_vec<G::VEC>(V + (k + kk) * G::LD + 16 * G::VEC * j + G::VEC * tx,
                         v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = kk == 0 ? p[i].x
                         : kk == 1 ? p[i].y
                         : kk == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int e = 0; e < G::VEC; ++e)
            acc[i][j * G::VEC + e] = fmaf(pk, v[e], acc[i][j * G::VEC + e]);
        }
      }
    }
  }
}

}  // namespace
