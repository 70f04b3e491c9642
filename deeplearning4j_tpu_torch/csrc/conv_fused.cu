// Fused convolution + batch-norm statistics for Hopper (sm_90a), float32
// and bfloat16 inputs, float32 accumulation.
//
//   stats_gemm_kernel<T, false> — replaces the TPU kernel B7a,
//     deeplearning4j_tpu/ops/conv_fused.py `_mm_stats_kernel`:
//     y = x2d @ w ([M, K] @ [K, N], the 1x1 convolution over NHWC rows).
//   stats_gemm_kernel<T, true>  — replaces B7b, `_conv3_stats_kernel`: the
//     3x3 stride-1 SAME convolution over NHWC x [B, H, W, C] with an HWIO
//     kernel, as an implicit GEMM: M = B·H·W output pixels, K = 9·C (tap
//     dh, tap dw, input channel: the row order of the HWIO kernel read as
//     [9·C, N]), N = C_out.
//   stats_reduce_kernel — the second launch of both: the per-tile column
//     partials summed over the M tiles.
//
// Each block owns a 128x64 tile of y and walks K itself, 16 deep: the next
// slice's loads are in flight in registers while the current one, staged
// in shared memory as float32, is multiplied, 8x4 outputs a thread (the
// 128x64 SGEMM tile of `lstm_drw_kernel` in csrc/lstm.cu). There is no
// sequential grid as on the TPU, so the epilogue cannot sum a column over
// all of M: while the tile is still in registers the block writes y,
// rounded once to the working dtype, and its own column partials of Σy and
// Σy², taken from the UNROUNDED float32 accumulator as JAX does; the second
// launch sums the [M tiles, N] partials in a fixed order. No atomics, so
// the statistics do not change from run to run. Ragged M, K and N are
// masked in the loads (zeros add nothing to a product or a sum) and in the
// stores, so every shape is taken; the TPU's block picker and its XLA
// fallback have no counterpart. B7b's zero halo is a predicate on the load
// (the tap's input pixel lies outside the map), not a padded copy: the
// TPU kernel's VMEM `xpad` and its VMEM budget are TPU matters.
//
// Bound. 2·M·K·N flops against the card's float32 FFMA rate (67 TFLOP/s)
// in both dtypes: this is plain FFMA, no tensor cores, so in bfloat16 the
// kernel stands far above its bound (989 TFLOP/s on the tensor cores, or
// the bytes where K or N is small). A K slice is read from device memory
// (L2 in practice) once per block: x is re-read N/64 times and w M/128
// times. The redesign, in order: mma.sync/wgmma on bfloat16 operands, TMA
// loads into a shared-memory ring, and stride-aware loads of the strided
// 1x1 (the wrapper passes a dense copy of the strided rows today).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileM = 128;
constexpr int kTileN = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;
constexpr int kPadM = kTileM + 4;        // staging rows, padded against
                                         // bank conflicts, 16-byte aligned
constexpr int kRowsA = kTileM * kDepth / kThreads;   // 8 A loads a thread
constexpr int kRowsB = kTileN * kDepth / kThreads;   // 4 B loads a thread
constexpr int kWarps = kThreads / 32;
constexpr int kFarRow = 0x7fff;          // an out-of-map row for B7b's loads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// x: [M, K] (kConv false) or NHWC [B, H, W, C] with M = B·H·W, K = 9·C
// (kConv true); w: [K, N]; y: [M, N]; part: [2, gridDim.y, N] float32 (Σy
// then Σy² of each M tile).
template <typename T, bool kConv>
__global__ void __launch_bounds__(kThreads)
stats_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, float* __restrict__ part, int M, int K,
                  int N, int H, int W, int C) {
  __shared__ __align__(16) float a_s[2][kDepth][kPadM];
  __shared__ __align__(16) float b_s[2][kDepth][kTileN];
  __shared__ float red[2][kWarps][kTileN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  // loads: A element (row r0 + 16 i, depth ka), B element (depth kb + 4 i,
  // column nb); neighbouring threads read neighbouring addresses
  const int ka = tid % kDepth, r0 = tid / kDepth;
  const int nb = tid % kTileN, kb = tid / kTileN;
  // compute: rows ty·8 .. +8, columns tx·4 .. +4 of the tile
  const int tx = tid % 16, ty = tid / 16;

  int rowm[kRowsA];
  int rowhw[kRowsA];           // B7b: oh << 16 | ow of the output pixel
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const int m = m0 + r0 + 16 * i;
    rowm[i] = m;
    if constexpr (kConv) {
      rowhw[i] = m < M ? (((m / W) % H) << 16) | (m % W) : kFarRow << 16;
    }
  }
  // B7b: this thread's depth k = k0 + ka as (tap, channel), advanced by
  // kDepth a slice without a division
  int tap = kConv ? ka / C : 0, ch = kConv ? ka % C : 0;

  float ra[kRowsA], rb[kRowsB];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto load = [&](int k0) {
    if constexpr (kConv) {
      const bool tap_ok = tap < 9;
      const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) {
        const int ih = (rowhw[i] >> 16) + dh, iw = (rowhw[i] & 0xffff) + dw;
        const bool ok = tap_ok && (unsigned)ih < (unsigned)H &&
                        (unsigned)iw < (unsigned)W;
        ra[i] = ok ? to_f(x[((int64_t)rowm[i] + dh * W + dw) * C + ch])
                   : 0.f;
      }
    } else {
      const int k = k0 + ka;
#pragma unroll
      for (int i = 0; i < kRowsA; ++i)
        ra[i] = (rowm[i] < M && k < K)
            ? to_f(x[(int64_t)rowm[i] * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) {
      const int k = k0 + kb + 4 * i, n = n0 + nb;
      rb[i] = (k < K && n < N) ? to_f(w[(int64_t)k * N + n]) : 0.f;
    }
  };
  auto advance = [&]() {
    if constexpr (kConv) {
      ch += kDepth;
      while (ch >= C) {
        ch -= C;
        ++tap;
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) a_s[buf][ka][r0 + 16 * i] = ra[i];
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) b_s[buf][kb + 4 * i][nb] = rb[i];
  };

  load(0);
  stage(0);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    const bool more = k0 + kDepth < K;
    if (more) {
      advance();
      load(k0 + kDepth);
    }
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&a_s[cur][r][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[cur][r][ty * 8 + 4]);
      const float4 b4 =
          *reinterpret_cast<const float4*>(&b_s[cur][r][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stage(cur ^ 1);
    __syncthreads();
    cur ^= 1;
  }

  // y, rounded once; rows past M hold zeros (their A rows were masked)
  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = acc[i][j];
      s[j] += v;
      q[j] = fmaf(v, v, q[j]);
      const int col = n0 + tx * 4 + j;
      if (row < M && col < N) store(&y[(int64_t)row * N + col], v);
    }
  }
  // column partials: the two row groups of a warp by shuffle, then the
  // eight warps in order through shared memory
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
    q[j] += __shfl_xor_sync(0xffffffffu, q[j], 16);
  }
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][warp][tx * 4 + j] = s[j];
      red[1][warp][tx * 4 + j] = q[j];
    }
  }
  __syncthreads();
  if (tid < 2 * kTileN) {
    const int which = tid / kTileN, col = tid % kTileN;
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) t += red[which][v][col];
    if (n0 + col < N)
      part[((int64_t)which * gridDim.y + blockIdx.y) * N + n0 + col] = t;
  }
}

// sums[which, n] = Σ over the M tiles of part[which, tile, n]: 16 strided
// running sums a column, then those 16 in order
constexpr int kRedCols = 32;
constexpr int kRedRows = 16;

__global__ void stats_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ sums, int tiles,
                                    int N) {
  __shared__ float red[kRedRows][kRedCols];
  const int n = blockIdx.x * kRedCols + threadIdx.x;
  const int which = blockIdx.y;
  float t = 0.f;
  if (n < N)
    for (int i = threadIdx.y; i < tiles; i += kRedRows)
      t += part[((int64_t)which * tiles + i) * N + n];
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < kRedRows; ++r) tot += red[r][threadIdx.x];
    sums[which * N + n] = tot;
  }
}

template <typename T, bool kConv>
int launch(const void* x, const void* w, void* y, void* part, void* sums,
           int M, int K, int N, int H, int W, int C, cudaStream_t st) {
  const int tiles = (M + kTileM - 1) / kTileM;
  const dim3 grid((N + kTileN - 1) / kTileN, tiles);
  stats_gemm_kernel<T, kConv><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      static_cast<float*>(part), M, K, N, H, W, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_reduce_kernel<<<dim3((N + kRedCols - 1) / kRedCols, 2),
                        dim3(kRedCols, kRedRows), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(sums), tiles, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows of y a block owns: the caller sizes part [2, ceil(M / tile), N]
int dl4j_conv_stats_tile_m() { return kTileM; }

// B7a. Contiguous x [M, K], w [K, N] of one dtype (0 float32, 1 bfloat16);
// out y [M, N] in that dtype, part [2, ceil(M / 128), N] and sums [2, N]
// float32 (Σy, Σy²). Returns 0 or a cudaError_t.
int dl4j_matmul_stats(const void* x, const void* w, void* y, void* part,
                      void* sums, int M, int K, int N, int dtype,
                      void* stream) {
  if (M < 1 || K < 1 || N < 1 || (M + kTileM - 1) / kTileM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(x, w, y, part, sums, M, K, N, 1, 1, 1, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, w, y, part, sums, M, K, N, 1, 1,
                                        1, st);
  return (int)cudaErrorInvalidValue;
}

// B7b. Contiguous x [B, H, W, C] (NHWC), w [3, 3, C, N] (HWIO) of one
// dtype; out y [B, H, W, N], part [2, ceil(B·H·W / 128), N], sums [2, N].
int dl4j_conv3x3_stats(const void* x, const void* w, void* y, void* part,
                       void* sums, int B, int H, int W, int C, int N,
                       int dtype, void* stream) {
  const int64_t M = (int64_t)B * H * W;
  if (B < 1 || H < 1 || W < 1 || C < 1 || N < 1 || H >= kFarRow ||
      W >= kFarRow || M > INT32_MAX || 9LL * C > INT32_MAX ||
      (M + kTileM - 1) / kTileM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(x, w, y, part, sums, (int)M, 9 * C, N, H, W,
                               C, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(x, w, y, part, sums, (int)M, 9 * C, N,
                                       H, W, C, st);
  return (int)cudaErrorInvalidValue;
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
