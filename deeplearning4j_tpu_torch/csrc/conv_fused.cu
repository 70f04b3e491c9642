// Fused convolution + batch-norm statistics for Hopper (sm_90a), float32
// and bfloat16 inputs, float32 accumulation. Two designs of each kernel,
// chosen per call by `b7_design` in ops/conv_fused.py (by dtype and
// alignment, before the launch; neither falls back to the other):
//
//   B7a replaces deeplearning4j_tpu/ops/conv_fused.py `_mm_stats_kernel`:
//     y = x2d @ w ([M, K] @ [K, N], the 1x1 convolution over NHWC rows).
//   B7b replaces `_conv3_stats_kernel`: the 3x3 stride-1 SAME convolution
//     over NHWC x [B, H, W, C] with an HWIO kernel, as an implicit GEMM:
//     M = B·H·W output pixels, K = 9·C (tap dh, tap dw, input channel: the
//     row order of the HWIO kernel read as [9·C, N]), N = C_out.
//   stats_reduce_kernel — the second launch of both: the per-tile column
//     partials summed over the M tiles in a fixed order.
//
// Both write y rounded once to the working dtype and, while the output
// tile is still in registers, its column partials of Σy and Σy² taken
// from the UNROUNDED float32 accumulator, as JAX does. There is no
// sequential grid as on the TPU, so a tile cannot sum a column over all
// of M: the [M tiles, N] partials go to `part` and the second launch sums
// them. No atomics, so the statistics do not change from run to run.
//
// Design 2, `tc::tc_stats_kernel` — bfloat16 whose rows are 16-byte
// aligned (K or C and N multiples of 8, aligned data): every shape of
// ResNet-50's training step. Bound on this card: the tensor cores (989
// TFLOP/s) where K and N are large, HBM where K or N is 64-256 and M is
// 100k-400k rows. A persistent block a SM walks 128 x BN tiles of y (BN =
// N rounded up to 64, 128 or 256, so x is read once where N <= 256); one
// producer thread keeps TMA loads of 64-deep K slices (128 bytes of
// bfloat16, 128-byte swizzle) in flight through a ring of 3-4 stages
// guarded by full/empty mbarriers, across tile boundaries, so one tile's
// epilogue overlaps the next tile's loads; two consumer warpgroups each
// run `wgmma` m64nBNk16 on their 64 rows, w read N-major through the
// transpose bit (no transposed copy). The epilogue stages y in shared
// memory for one TMA store and sums the statistics from the accumulator
// fragments: a thread's two rows, a butterfly over the 8 lanes that hold
// the same columns, then the 8 warps in order through shared memory.
// B7b's halo: a tap's A tile is the 2-D [B·H·W, C] map read at the output
// rows shifted by (dh - 1)·W + (dw - 1) (TMA zero-fills rows off the
// tensor and channels past C; w is a 3-D [9, C, N] map so a slice never
// reads the next tap's rows), and the consumers zero, in shared memory,
// the rows whose tap pixel lies off the map or past M, then fence the
// generic-proxy writes before `wgmma` reads them. A row is 64 channels =
// 128 bytes, so the swizzle does not move it. This keeps B7a's flat
// 128-row M tiling at every map size; a 4-D NHWC box per (tap, channel
// slice) would get its halo from TMA alone but waste most of a box's rows
// on the 7x7 and 14x14 maps. The price: each tap re-reads x (9x, from L2),
// which bounds the 56x56 C 64 shape, where BN is 64, by L2 bandwidth.
//
// Design 1, `stats_gemm_kernel` — float32 (exact FMA, as the CPU tests and
// the card-against-CPU checks need) and the bfloat16 shapes design 2 does
// not take. Each block owns a 128x64 tile of y and walks K itself, 16
// deep: the next slice's loads are in flight in registers while the
// current one, staged in shared memory as float32, is multiplied, 8x4
// outputs a thread (the 128x64 SGEMM tile of `lstm_drw_kernel` in
// csrc/lstm.cu). Ragged M, K and N are masked in the loads (zeros add
// nothing to a product or a sum) and in the stores, so every shape is
// taken; the TPU's block picker and its XLA fallback have no counterpart.
// B7b's zero halo is a predicate on the load, not a padded copy (the TPU
// kernel's VMEM `xpad` and its budget are TPU matters). Bound: 2·M·K·N
// flops against the card's float32 FFMA rate (67 TFLOP/s); a K slice is
// read once per block, so x is re-read N/64 times and w M/128 times.
//
// Left for later: stride-aware loads of the strided 1x1 (the wrapper
// passes a dense copy of the strided rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_gemm.cuh"

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

// ------------------------------------------------------------------------
// Design 2: bfloat16 on the tensor cores (wgmma fed by TMA)
// ------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kM = 128;               // rows of a y tile (2 warpgroups x 64)
constexpr int kK = 64;                // a K slice: 64 bf16 = 128 bytes
constexpr int kThreads = 384;         // warpgroups 0, 1 compute; 2 loads
constexpr int kABytes = kM * kK * 2;  // 16 KB of x a stage
constexpr int kBoxBytes = 64 * 64 * 2;  // one 64 x 64 box of w or of y

// shared memory of a block: 1024 bytes of slack to align the ring to a
// swizzle atom, the ring of `stages` (x slice + BN/64 boxes of w), the y
// tile staged for the TMA store, the column partials [2][8 warps][bn],
// and the 2 x stages barriers
__host__ __device__ constexpr int stage_bytes(int bn) {
  return kABytes + (bn / 64) * kBoxBytes;
}
__host__ __device__ constexpr int smem_bytes(int bn, int stages) {
  return 1024 + stages * stage_bytes(bn) + kM * bn * 2 + 2 * 8 * bn * 4 +
         2 * stages * 8;
}

// One step of a butterfly sum over lanes `kBit` apart: values i and
// i + kHalf are paired; the lane with `kBit` clear keeps i, the other
// i + kHalf, and each adds its partner's copy of the value it keeps.
template <int kHalf, int kBit, int kN>
__device__ __forceinline__ void trade_half(float (&v)[kN], int lane) {
  const bool upper = lane & kBit;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kBit);
  }
}

// x: [M, K] rows (kConv false) or the NHWC input as [M, C] rows (kConv
// true, M = B·H·W, K = 9·C ordered (tap, channel)); w: [K, N] (kConv
// false) or [9, C, N]; y: [M, N]; all bfloat16, through tensor maps.
// part: [2, tiles_m, N] float32. A persistent block walks the tiles
// blockIdx.x, + gridDim.x, ... (N fastest); its producer warp runs ahead
// through the ring across tiles, so one tile's epilogue overlaps the next
// tile's loads. kslices: K slices of 64 a tile (kConv: 9 x cslices, the
// slices of C).
template <int BN, bool kConv>
__global__ void __launch_bounds__(kThreads, 1)
tc_stats_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap ymap,
                float* __restrict__ part, int M, int N, int kslices,
                int cslices, int stages, int H, int W) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ys = ring + stages * stage_bytes(BN);
  float* red = reinterpret_cast<float*>(ys + kM * BN * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 8 * BN);
  uint64_t* empty = full + stages;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles_m = (M + kM - 1) / kM;
  const int tiles = tiles_m * tiles_n;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);    // one arrival from each warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    if constexpr (BN == 256) reg_dealloc<40>();
    if (t == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < kslices; ++kt, ++it) {
          const int s = it % stages, round = it / stages;
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* st = ring + s * stage_bytes(BN);
          mbar_expect_tx(&full[s], stage_bytes(BN));
          if constexpr (kConv) {
            // the tap's rows of x: the output rows shifted by the tap's
            // offset; the consumers zero the rows whose tap pixel is off
            // the map
            const int tap = kt / cslices, c0 = (kt % cslices) * kK;
            const int shift = (tap / 3 - 1) * W + (tap % 3 - 1);
            tma_load_2d(st, &xmap, &full[s], c0, m0 + shift);
#pragma unroll
            for (int nb = 0; nb < BN / 64; ++nb)
              tma_load_3d(st + kABytes + nb * kBoxBytes, &wmap, &full[s],
                          n0 + nb * 64, c0, tap);
          } else {
            tma_load_2d(st, &xmap, &full[s], kt * kK, m0);
#pragma unroll
            for (int nb = 0; nb < BN / 64; ++nb)
              tma_load_2d(st + kABytes + nb * kBoxBytes, &wmap, &full[s],
                          n0 + nb * 64, kt * kK);
          }
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  if constexpr (BN == 256) reg_alloc<232>();
  const int warp = t / 32, lane = t % 32;
  uint8_t* ywg = ys + wg * 64 * BN * 2;       // this warpgroup's 64 rows
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tm = tile / tiles_n, m0 = tm * kM, n0 = (tile % tiles_n) * BN;
    // a tile's own accumulators: zeroed here, so nothing of the last
    // tile's stays live through its epilogue
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // B7b: the row of the A tile this thread zeroes (half of its 128
    // bytes) where the row's tap pixel is off the map or the row past M
    int zh = -4, zw = 0;
    if constexpr (kConv) {
      const int m = m0 + wg * 64 + t / 2;
      if (m < M) {
        zh = (m / W) % H;
        zw = m % W;
      }
    }
    int prev = 0;
    for (int kt = 0; kt < kslices; ++kt, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      uint8_t* a = ring + s * stage_bytes(BN) + wg * 64 * 128;
      const uint8_t* b = ring + s * stage_bytes(BN) + kABytes;
      if constexpr (kConv) {
        const int tap = kt / cslices;
        if (tap != 4) {     // the centre tap reads its own rows: no halo
          const int dh = tap / 3 - 1, dw = tap % 3 - 1;
          if ((unsigned)(zh + dh) >= (unsigned)H ||
              (unsigned)(zw + dw) >= (unsigned)W) {
            uint4* p = reinterpret_cast<uint4*>(a + (t / 2) * 128 +
                                                (t % 2) * 64);
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async();
          bar_sync(2 + wg, 128);
        }
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk)
        WgmmaBf16<BN, 1>::run(acc, sw128_desc(a + kk * 32, 16, 1024),
                              sw128_desc(b + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      fence_regs(acc);
      // the previous slice's products are done: its stage goes back
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && t == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (t == 0) mbar_arrive(&empty[prev]);

    // epilogue. The staged y of the previous tile has been read by its
    // store, and every thread is done with the partials of that tile.
    if (threadIdx.x == 0) tma_store_wait_read();
    bar_sync(1, 256);
    // y rounded once into the 128B-swizzled staging tile (box j / 8,
    // 16-byte chunk j % 8; rows r0 and r0 + 8 share the chunk's swizzle)
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint8_t* p = ywg + (j / 8) * kBoxBytes + sw128_offset(r0, j % 8) +
                   (lane % 4) * 4;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    // Σy and Σy² of each column from the float32 accumulator, in place:
    // the thread's two
    // rows, then a butterfly over the 8 lanes that hold the same columns
    // (lane bits 4, 3, 2), each step keeping half the values and trading
    // the other half, so a lane ends with BN / 16 of its warp's 16-row
    // sums; then the 8 warps in order through shared memory
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float a0 = acc[4 * j], a1 = acc[4 * j + 1];
      const float a2 = acc[4 * j + 2], a3 = acc[4 * j + 3];
      acc[4 * j] = a0 + a2;
      acc[4 * j + 1] = a1 + a3;
      acc[4 * j + 2] = fmaf(a0, a0, a2 * a2);
      acc[4 * j + 3] = fmaf(a1, a1, a3 * a3);
    }
    constexpr int kV = BN / 2;
    trade_half<kV / 2, 16>(acc, lane);
    trade_half<kV / 4, 8>(acc, lane);
    trade_half<kV / 8, 4>(acc, lane);
    // lane holds values base + i, i < kV / 8, where value 4 j + e is
    // column 8 j + 2 (lane % 4) + (e % 2) of Σy (e < 2) or Σy² (e >= 2)
    const int base = ((lane >> 4) & 1) * (kV / 2) +
                     ((lane >> 3) & 1) * (kV / 4) +
                     ((lane >> 2) & 1) * (kV / 8);
    const int row = wg * 4 + warp;
#pragma unroll
    for (int i = 0; i < kV / 8; ++i) {
      const int idx = base + i, e = idx % 4;
      const int c = 8 * (idx / 4) + 2 * (lane % 4) + (e & 1);
      red[((e >> 1) * 8 + row) * BN + c] = acc[i];
    }
    fence_proxy_async();
    bar_sync(1, 256);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nb = 0; nb < BN / 64; ++nb)
          if (m0 + h * 64 < M && n0 + nb * 64 < N)
            tma_store_2d(&ymap, ys + h * 64 * BN * 2 + nb * kBoxBytes,
                         n0 + nb * 64, m0 + h * 64);
      tma_store_commit();
    }
    for (int i = threadIdx.x; i < 2 * BN; i += 256) {
      const int which = i / BN, c = i % BN;
      float tot = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) tot += red[(which * 8 + u) * BN + c];
      if (n0 + c < N)
        part[((int64_t)which * tiles_m + tm) * N + n0 + c] = tot;
    }
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

// kdim: K (kConv false) or C; returns 0 or a cudaError_t
template <int BN, bool kConv>
int launch(const void* x, const void* w, void* y, void* part, void* sums,
           int M, int kdim, int N, int H, int W, int stages,
           cudaStream_t st) {
  CUtensorMap xm, wm, ym;
  const uint64_t xd[2] = {(uint64_t)kdim, (uint64_t)M};
  const uint64_t xs[1] = {(uint64_t)kdim * 2};
  const uint32_t xb[2] = {kK, kM};
  int rc = encode_tensor_map(&xm, x, 2, xd, xs, xb);
  if (rc) return rc;
  if constexpr (kConv) {
    const uint64_t wd[3] = {(uint64_t)N, (uint64_t)kdim, 9};
    const uint64_t ws[2] = {(uint64_t)N * 2, (uint64_t)kdim * N * 2};
    const uint32_t wb[3] = {64, kK, 1};
    rc = encode_tensor_map(&wm, w, 3, wd, ws, wb);
  } else {
    const uint64_t wd[2] = {(uint64_t)N, (uint64_t)kdim};
    const uint64_t ws[1] = {(uint64_t)N * 2};
    const uint32_t wb[2] = {64, kK};
    rc = encode_tensor_map(&wm, w, 2, wd, ws, wb);
  }
  if (rc) return rc;
  const uint64_t yd[2] = {(uint64_t)N, (uint64_t)M};
  const uint64_t ysd[1] = {(uint64_t)N * 2};
  const uint32_t yb[2] = {64, 64};
  rc = encode_tensor_map(&ym, y, 2, yd, ysd, yb);
  if (rc) return rc;

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int smem = smem_bytes(BN, stages);
  e = cudaFuncSetAttribute(tc_stats_kernel<BN, kConv>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int cslices = (kdim + kK - 1) / kK;
  const int kslices = kConv ? 9 * cslices : cslices;
  const int tiles_m = (M + kM - 1) / kM;
  const int tiles = tiles_m * ((N + BN - 1) / BN);
  tc_stats_kernel<BN, kConv><<<tiles < sms ? tiles : sms, kThreads, smem,
                               st>>>(
      xm, wm, ym, static_cast<float*>(part), M, N, kslices, cslices, stages,
      H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_reduce_kernel<<<dim3((N + kRedCols - 1) / kRedCols, 2),
                        dim3(kRedCols, kRedRows), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(sums), tiles_m,
      N);
  return (int)cudaGetLastError();
}

template <bool kConv>
int dispatch(const void* x, const void* w, void* y, void* part, void* sums,
             int M, int kdim, int N, int H, int W, int bn, int stages,
             cudaStream_t st) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  // the ring must hold two slices: a consumer gives a stage back one
  // slice after it was filled
  if (!aligned || M < 1 || kdim < 8 || N < 8 || kdim % 8 || N % 8 ||
      stages < 2 || smem_bytes(bn, stages) > 232448 ||
      (M + kM - 1) / kM > 65535)
    return (int)cudaErrorInvalidValue;
  if (bn == 64)
    return launch<64, kConv>(x, w, y, part, sums, M, kdim, N, H, W, stages,
                             st);
  if (bn == 128)
    return launch<128, kConv>(x, w, y, part, sums, M, kdim, N, H, W, stages,
                              st);
  if (bn == 256)
    return launch<256, kConv>(x, w, y, part, sums, M, kdim, N, H, W, stages,
                              st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

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

// Design 2 of B7a, bfloat16 on the tensor cores: x [M, K], w [K, N], y
// [M, N] bfloat16 with K and N multiples of 8 and 16-byte aligned data;
// part and sums as above. bn: columns of a y tile (64, 128 or 256);
// stages: depth of the shared-memory ring (2 or more, as many as fit).
int dl4j_matmul_stats_wgmma(const void* x, const void* w, void* y,
                            void* part, void* sums, int M, int K, int N,
                            int bn, int stages, void* stream) {
  return tc::dispatch<false>(x, w, y, part, sums, M, K, N, 1, 1, bn, stages,
                             static_cast<cudaStream_t>(stream));
}

// Design 2 of B7b: x [B, H, W, C], w [3, 3, C, N], y [B, H, W, N]
// bfloat16, C and N multiples of 8; bn and stages as for B7a.
int dl4j_conv3x3_stats_wgmma(const void* x, const void* w, void* y,
                             void* part, void* sums, int B, int H, int W,
                             int C, int N, int bn, int stages,
                             void* stream) {
  const int64_t M = (int64_t)B * H * W;
  if (B < 1 || H < 1 || W < 1 || M > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  return tc::dispatch<true>(x, w, y, part, sums, (int)M, C, N, H, W, bn,
                            stages, static_cast<cudaStream_t>(stream));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
