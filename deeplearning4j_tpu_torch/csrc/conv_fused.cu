// Fused convolution + batch-norm statistics for Hopper (sm_90a), float32
// and bfloat16 inputs, float32 accumulation. Three designs of each kernel,
// chosen per call by `b7_design` in ops/conv_fused.py (by dtype and
// alignment, before the launch; none falls back to another):
//
//   B7a replaces deeplearning4j_tpu/ops/conv_fused.py `_mm_stats_kernel`:
//     y = x2d @ w ([M, K] @ [K, N], the 1x1 convolution over NHWC rows).
//   B7b replaces `_conv3_stats_kernel`: the 3x3 stride-1 SAME convolution
//     over NHWC x [B, H, W, C] with an HWIO kernel, as an implicit GEMM:
//     M = B·H·W output pixels, K = 9·C (tap dh, tap dw, input channel: the
//     row order of the HWIO kernel read as [9·C, N]), N = C_out.
//   stats_reduce_kernel — the second launch of both: the per-tile column
//     partials summed over the M tiles in a fixed order (design 3 in
//     double, rounded once).
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
// Design 3, `tf3::tf32x3_stats_kernel` — float32 whose rows are 16-byte
// aligned (K or C and N multiples of 4, aligned data): every shape of
// ResNet-50's training step in float32. Design 1 runs on the FMA units (67
// TFLOP/s) and reached 41-47% of that bound, so no FMA kernel would come
// near cuBLAS's or cuDNN's float32 times; the tensor cores take float32
// only as TF32, so each operand x is split into big = tf32(x) and small =
// tf32(x - big) (rounded to nearest, ties away, as `cvt.rna`) and each
// product taken as small·big + big·small + big·big: three TF32 products
// (bound 495 / 3 TFLOP/s), about 22 bits of each operand kept, never a
// float32 operand rounded to one TF32 term (C17, as the float32 flash
// kernels). Design 2's skeleton: a persistent block a SM, one producer
// thread keeping TMA loads in flight through a ring across tiles, two
// consumer warpgroups on 64 rows each of a 128 x BN tile (BN 64 or 128).
// What float32 changes:
// - tf32 `wgmma` (m64nBNk8) reads B from shared memory K-major only (no
//   transpose bit), so a split pass at the start of the call rewrites w
//   ([K, N], or [9, C, N]) once into two K-major planes [2, 9, N, C]: big
//   and small. w is at most 9·512·512 floats: microseconds.
// - x is never rewritten: the consumers load their A fragments of each
//   32-deep slice (128 bytes a row, 128-byte swizzle) from shared memory
//   into registers, split them there and multiply in `wgmma`'s
//   register-A form against the two planes' boxes. A split pass over x
//   would triple x's traffic on the shapes bound by bytes.
// - Sums: the tensor cores add a product's terms and its accumulator
//   aligned and truncated toward zero, so every `wgmma` that chains onto
//   an accumulator leaves it short by up to a unit in the last place of
//   its running value, always toward zero: a long chain drifts (as
//   measured on the float32 flash kernels), and Σy², which sums y² over
//   up to 401,408 rows, adds that drift up coherently. So a group of
//   kFlush k8 steps takes its products into a fresh accumulator, first
//   every small·big and big·small product (their truncations fall at the
//   small terms' magnitude, about 2^-11 of y's), then the big·big ones,
//   so that only the group's kFlush big·big steps truncate at y's own
//   magnitude; the group is then added to the float32 sum on the FMA
//   units, rounded to nearest. Nothing is added back for the truncation:
//   where every product and partial sum is exact in the tensor cores
//   (TF32-exact data such as small integers or one-hot rows) y is exact,
//   as design 1's; elsewhere |y| stays a fraction of a unit short on
//   average, and the guard (y, Σy and Σy² against float64 within twice
//   design 1's error; C17 in ROADMAP.md) is what bounds it, and chose
//   kFlush 1: with 2 or 4 the guard read 2.2-2.5 on post-ReLU x (PERF.md,
//   B7 float32). Two accumulators of 64 x BN: so BN <= 128, and N
//   256-2048 runs as column tiles. The tiles' partial statistics are
//   summed in float64.
// - B7b's taps: a channel slice's x tile with its halo, rows m0 - W - 1
//   .. m0 + 128 + W, is staged once in a slot of its own and read at each
//   tap's row offset, as the TPU kernel's `xpad` is; rows whose tap pixel
//   is off the map are zeroed in registers (no shared-memory write, no
//   fence). The tile is one TMA box of at most 256 rows, so W <= 63
//   (every ResNet-50 map); wider maps stay on design 1 (`b7_design`).
// - y is written from the accumulator as float2 pairs (whole 32-byte
//   sectors), not staged: float32 y would take the ring's room.
// The statistics are design 2's, from the float32 sum.
//
// Design 1, `stats_gemm_kernel` — the float32 and bfloat16 shapes designs
// 2 and 3 do not take (ragged K, C or N, unaligned data, float32 maps
// wider than 63), in exact
// float32 FMA. Each block owns a 128x64 tile of y and walks K itself, 16
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

#include <atomic>
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
constexpr int kMaxSmem = 232448;         // a block's shared memory on sm_90

// the card's SM count, which sizes the persistent grids of designs 2, 3
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

constexpr int kMaxDevices = 64;

// Lets `kernel` take a block's whole shared memory (kMaxSmem, so every
// size) on the current device, set once per device and instantiation
// (`set`, the caller's own flags), not on every launch: a launch that a
// CUDA graph captures sets nothing. A failure is returned and not
// remembered, so the next launch tries again. Returns 0 or a cudaError_t.
template <typename Kernel>
int allow_max_smem(Kernel kernel, std::atomic<bool> (&set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && set[dev].load(std::memory_order_acquire))
    return 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) set[dev].store(true, std::memory_order_release);
  return 0;
}

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
// running sums a column, then those 16 in order, in Acc (float for designs
// 1 and 2; design 3 sums in double and rounds once, so its statistics keep
// the kernel's own error and not the reduction's: PERF.md, B7 float32)
constexpr int kRedCols = 32;
constexpr int kRedRows = 16;

template <typename Acc>
__global__ void stats_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ sums, int tiles,
                                    int N) {
  __shared__ Acc red[kRedRows][kRedCols];
  const int n = blockIdx.x * kRedCols + threadIdx.x;
  const int which = blockIdx.y;
  Acc t = 0;
  if (n < N)
    for (int i = threadIdx.y; i < tiles; i += kRedRows)
      t += part[((int64_t)which * tiles + i) * N + n];
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    Acc tot = 0;
#pragma unroll
    for (int r = 0; r < kRedRows; ++r) tot += red[r][threadIdx.x];
    sums[which * N + n] = static_cast<float>(tot);
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
  stats_reduce_kernel<float><<<dim3((N + kRedCols - 1) / kRedCols, 2),
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

  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int smem = smem_bytes(BN, stages);
  static std::atomic<bool> limit_set[kMaxDevices];
  rc = allow_max_smem(tc_stats_kernel<BN, kConv>, limit_set);
  if (rc) return rc;
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
  stats_reduce_kernel<float><<<dim3((N + kRedCols - 1) / kRedCols, 2),
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
      stages < 2 || smem_bytes(bn, stages) > kMaxSmem ||
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

// ------------------------------------------------------------------------
// Design 3: float32 on the tensor cores as 3xTF32 (wgmma fed by TMA)
// ------------------------------------------------------------------------
namespace tf3 {

using namespace hopper;

constexpr int kM = 128;               // rows of a y tile (2 warpgroups x 64)
constexpr int kK = 32;                // a K slice: 32 float32 = 128 bytes
constexpr int kThreads = 384;         // warpgroups 0, 1 compute; 2 loads
constexpr int kABytes = kM * kK * 4;  // 16 KB of x a stage
constexpr int kHaloSlots = 2;         // x tiles with their halo in flight
constexpr int kMaxBoxRows = 256;      // a TMA box's largest side
// k8 steps whose products share a fresh accumulator before it is added to
// the float32 sum: every k8 step, as the guard decides (tools/
// torch_b7_tf32.py builds 2 and 4, once a slice: faster, but past the
// guard on post-ReLU data)
constexpr int kFlush = 1;
static_assert(kK / 8 % kFlush == 0, "a flush group divides a slice");

// one plane's box of w: bn rows of a 32-deep K slice
__host__ __device__ constexpr int b_bytes(int bn) { return bn * kK * 4; }
// a ring stage: the x slice (B7a; B7b reads x from its halo tiles) and
// both planes
__host__ __device__ constexpr int stage_bytes(int bn, bool conv) {
  return (conv ? 0 : kABytes) + 2 * b_bytes(bn);
}
// B7b's x tile: an M tile's rows with every tap's neighbours, output rows
// m0 - W - 1 .. m0 + 128 + W, in a slot of whole swizzle atoms
__host__ __device__ constexpr int halo_rows(int w) { return kM + 2 * w + 2; }
__host__ __device__ constexpr int halo_bytes(int w) {
  return (halo_rows(w) * kK * 4 + 1023) / 1024 * 1024;
}
// shared memory of a block: alignment slack, the ring, the halo slots
// (halo_w < 0: none), the column partials [2][8 warps][bn], the barriers
__host__ __device__ constexpr int smem_bytes(int bn, int stages,
                                             int halo_w) {
  return 1024 + stages * stage_bytes(bn, halo_w >= 0) +
         (halo_w >= 0 ? kHaloSlots * halo_bytes(halo_w) : 0) +
         2 * 8 * bn * 4 + 2 * (stages + kHaloSlots) * 8;
}

// x rounded to tf32 (10 stored mantissa bits), to nearest, ties away from
// zero, as `cvt.rna.tf32.f32` rounds a finite x (two integer
// instructions; ops/tf32.py `tf32_rna` is the same on the CPU)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The split pass: w [taps, R, N] (R = K or C) into planes [2, taps, N, R],
// big = tf32(w) then small = tf32(w - big), each transposed so that R runs
// fastest (tf32 `wgmma` reads B K-major only). 32 x 32 tiles through
// shared memory, so both sides are read and written in whole rows.
__global__ void split_w_kernel(const float* __restrict__ w,
                               float* __restrict__ planes, int taps, int R,
                               int N) {
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32, r0 = blockIdx.y * 32, tap = blockIdx.z;
  const float* src = w + (int64_t)tap * R * N;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, n = n0 + threadIdx.x;
    tile[i][threadIdx.x] = (r < R && n < N) ? src[(int64_t)r * N + n] : 0.f;
  }
  __syncthreads();
  const int64_t plane = (int64_t)taps * N * R;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, r = r0 + threadIdx.x;
    if (n < N && r < R) {
      uint32_t b, s;
      split(tile[threadIdx.x][i], b, s);
      const int64_t o = ((int64_t)tap * N + n) * R + r;
      planes[o] = __uint_as_float(b);
      planes[plane + o] = __uint_as_float(s);
    }
  }
}

// x: [M, K] rows (kConv false) or the NHWC input as [M, C] rows (kConv
// true, M = B·H·W, K = 9·C), float32, through a tensor map of 32-float
// boxes (128 x 32; kConv: halo_rows(W) x 32); wmap: the planes [2, taps,
// N, R] as a 3-D map {R, N, 2 taps} of bn x 32 boxes; y [M, N] float32,
// part [2, tiles_m, N]. A persistent block walks the tiles blockIdx.x, +
// gridDim.x, ... (N fastest); its producer thread runs ahead through the
// ring across tiles. The K slices are 32 deep; kConv takes them in
// (channel slice, tap) order, a channel slice's nine taps read from one x
// tile with its halo.
template <int BN, bool kConv>
__global__ void __launch_bounds__(kThreads, 1)
tf32x3_stats_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    float* __restrict__ y, float* __restrict__ part, int M,
                    int N, int cslices, int stages, int H, int W) {
  constexpr int kStage = stage_bytes(BN, kConv);
  constexpr int kTaps = kConv ? 9 : 1;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* hring = ring + stages * kStage;
  const int hbytes = kConv ? halo_bytes(W) : 0;
  float* red = reinterpret_cast<float*>(hring + kHaloSlots * hbytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 8 * BN);
  uint64_t* empty = full + stages;
  uint64_t* hfull = empty + stages;
  uint64_t* hempty = hfull + kHaloSlots;
  const int kslices = kTaps * cslices;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles_m = (M + kM - 1) / kM;
  const int tiles = tiles_m * tiles_n;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    // a stage goes back when each of the 8 consumer warps is done with it
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    for (int s = 0; s < kHaloSlots; ++s) {
      mbar_init(&hfull[s], 1);
      mbar_init(&hempty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    if constexpr (BN == 128) reg_dealloc<40>();
    if (t == 0) {
      int it = 0, ih = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < kslices; ++kt, ++it) {
          const int tap = kConv ? kt % 9 : 0;
          const int c0 = (kConv ? kt / 9 : kt) * kK;
          if constexpr (kConv) {
            if (tap == 0) {
              const int sh = ih % kHaloSlots, round = ih / kHaloSlots;
              if (round > 0) mbar_wait(&hempty[sh], (round - 1) & 1);
              mbar_expect_tx(&hfull[sh], halo_rows(W) * kK * 4);
              tma_load_2d(hring + sh * hbytes, &xmap, &hfull[sh], c0,
                          m0 - W - 1);
              ++ih;
            }
          }
          const int s = it % stages, round = it / stages;
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* b = ring + s * kStage;
          mbar_expect_tx(&full[s], kStage);
          if constexpr (!kConv) {
            tma_load_2d(b, &xmap, &full[s], c0, m0);
            b += kABytes;
          }
          tma_load_3d(b, &wmap, &full[s], c0, n0, tap);
          tma_load_3d(b + b_bytes(BN), &wmap, &full[s], c0, n0,
                      kTaps + tap);
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  if constexpr (BN == 128) reg_alloc<232>();
  const int warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  // this thread's rows of a tile: r0 and r0 + 8 (A fragment and
  // accumulator alike)
  const int r0 = wg * 64 + warp * 16 + g;
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
  int it = 0, ih = 0;
  const uint8_t* hx = nullptr;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tm = tile / tiles_n, m0 = tm * kM, n0 = (tile % tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // B7b: the output pixels of the two rows; a row past M lies off the
    // map for every tap
    int ph[2] = {-4, -4}, pw[2] = {0, 0};
    if constexpr (kConv) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + r0 + 8 * e;
        if (m < M) {
          ph[e] = (m / W) % H;
          pw[e] = m % W;
        }
      }
    }
    for (int kt = 0; kt < kslices; ++kt, ++it) {
      const int tap = kConv ? kt % 9 : 0;
      if constexpr (kConv) {
        if (tap == 0) {
          mbar_wait(&hfull[ih % kHaloSlots], (ih / kHaloSlots) & 1);
          hx = hring + (ih % kHaloSlots) * hbytes;
        }
      }
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const uint8_t* st = ring + s * kStage;
      // A: the x slice of the stage, or the halo tile at the tap's offset
      const uint8_t* a = kConv ? hx : st;
      const int arow = kConv ? r0 + (tap / 3) * W + tap % 3 : r0;
      const uint8_t* bbig = kConv ? st : st + kABytes;
      const uint8_t* bsmall = bbig + b_bytes(BN);
      bool ok[2] = {true, true};
      if constexpr (kConv) {
        const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ok[e] = (unsigned)(ph[e] + dh) < (unsigned)H &&
                  (unsigned)(pw[e] + dw) < (unsigned)W;
      }
      // the slice's A fragments, split: every load of the slice comes
      // before its first product, so a warp whose products are done has
      // read the stage
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = arow + 8 * (i & 1), col = 8 * kk + q + 4 * (i >> 1);
          const float v =
              ok[i & 1] ? *reinterpret_cast<const float*>(
                              a + sw128_offset(row, col >> 2) + (col & 3) * 4)
                        : 0.f;
          split(v, ab[kk][i], as[kk][i]);
        }
      // a group's products into `sum` from zero: its small·big and
      // big·small ones, then its big·big ones, which alone truncate at
      // y's magnitude; then `sum` into the float32 sum
#pragma unroll
      for (int k0 = 0; k0 < 4; k0 += kFlush) {
        wgmma_fence();
#pragma unroll
        for (int kk = k0; kk < k0 + kFlush; ++kk) {
          WgmmaTf32RS<BN>::run(sum, as[kk], sw128_desc(bbig + kk * 32, 16,
                                                       1024),
                               kk == k0 ? 0 : 1);
          WgmmaTf32RS<BN>::run(
              sum, ab[kk], sw128_desc(bsmall + kk * 32, 16, 1024), 1);
        }
#pragma unroll
        for (int kk = k0; kk < k0 + kFlush; ++kk)
          WgmmaTf32RS<BN>::run(sum, ab[kk],
                               sw128_desc(bbig + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sum);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fence_regs(ab[j]);
          fence_regs(as[j]);
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += sum[i];
      }
      if (lane == 0) mbar_arrive(&empty[s]);
      if constexpr (kConv) {
        if (tap == 8) {
          if (lane == 0) mbar_arrive(&hempty[ih % kHaloSlots]);
          ++ih;
        }
      }
    }

    // epilogue: y, each thread's float2 column pairs of its two rows
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      if (col >= N) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + r0 + 8 * e;
        if (row < M)
          *reinterpret_cast<float2*>(y + (int64_t)row * N + col) =
              make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
      }
    }
    // every consumer is done reading the last tile's partials
    bar_sync(1, 256);
    // Σy and Σy² of each column, as design 2 sums them
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
    tc::trade_half<kV / 2, 16>(acc, lane);
    tc::trade_half<kV / 4, 8>(acc, lane);
    tc::trade_half<kV / 8, 4>(acc, lane);
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
    bar_sync(1, 256);
    for (int i = threadIdx.x; i < 2 * BN; i += 256) {
      const int which = i / BN, c = i % BN;
      float tot = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) tot += red[(which * 8 + u) * BN + c];
      if (n0 + c < N)
        part[((int64_t)which * tiles_m + tm) * N + n0 + c] = tot;
    }
  }
}

// kdim: K (kConv false) or C; returns 0 or a cudaError_t
template <int BN, bool kConv>
int launch(const float* x, const float* w, float* planes, float* y,
           float* part, float* sums, int M, int kdim, int N, int H, int W,
           int stages, cudaStream_t st) {
  constexpr int kTaps = kConv ? 9 : 1;
  split_w_kernel<<<dim3((N + 31) / 32, (kdim + 31) / 32, kTaps),
                   dim3(32, 8), 0, st>>>(w, planes, kTaps, kdim, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap xm, wm;
  const uint64_t xd[2] = {(uint64_t)kdim, (uint64_t)M};
  const uint64_t xs[1] = {(uint64_t)kdim * 4};
  const uint32_t xb[2] = {kK, (uint32_t)(kConv ? halo_rows(W) : kM)};
  int rc = encode_tensor_map(&xm, x, 2, xd, xs, xb,
                             CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (rc) return rc;
  const uint64_t wd[3] = {(uint64_t)kdim, (uint64_t)N, 2 * kTaps};
  const uint64_t ws[2] = {(uint64_t)kdim * 4, (uint64_t)N * kdim * 4};
  const uint32_t wb[3] = {kK, BN, 1};
  rc = encode_tensor_map(&wm, planes, 3, wd, ws, wb,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (rc) return rc;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  static std::atomic<bool> limit_set[kMaxDevices];
  rc = allow_max_smem(tf32x3_stats_kernel<BN, kConv>, limit_set);
  if (rc) return rc;
  const int smem = smem_bytes(BN, stages, kConv ? W : -1);
  const int cslices = (kdim + kK - 1) / kK;
  const int tiles_m = (M + kM - 1) / kM;
  const int tiles = tiles_m * ((N + BN - 1) / BN);
  tf32x3_stats_kernel<BN, kConv>
      <<<tiles < sms ? tiles : sms, kThreads, smem, st>>>(
          xm, wm, y, part, M, N, cslices, stages, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_reduce_kernel<double><<<dim3((N + kRedCols - 1) / kRedCols, 2),
                                dim3(kRedCols, kRedRows), 0, st>>>(
      part, sums, tiles_m, N);
  return (int)cudaGetLastError();
}

template <bool kConv>
int dispatch(const void* x, const void* w, void* planes, void* y,
             void* part, void* sums, int M, int kdim, int N, int H, int W,
             int bn, int stages, cudaStream_t st) {
  // TMA: 16-byte aligned bases and row strides (kdim and N multiples of
  // 4), B7b's x tile with its halo in one box; y is written as float2
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(planes) |
        reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (!aligned || M < 1 || kdim < 4 || N < 4 || kdim % 4 || N % 4 ||
      stages < 2 || (kConv && halo_rows(W) > kMaxBoxRows) ||
      smem_bytes(bn, stages, kConv ? W : -1) > kMaxSmem ||
      (M + kM - 1) / kM > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(planes);
  float* yf = static_cast<float*>(y);
  float* partf = static_cast<float*>(part);
  float* sf = static_cast<float*>(sums);
  if (bn == 64)
    return launch<64, kConv>(xf, wf, pf, yf, partf, sf, M, kdim, N, H, W,
                             stages, st);
  if (bn == 128)
    return launch<128, kConv>(xf, wf, pf, yf, partf, sf, M, kdim, N, H, W,
                              stages, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tf3

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

// Design 3 of B7a, float32 as 3xTF32 on the tensor cores: x [M, K], w
// [K, N], y [M, N] float32 with K and N multiples of 4 and 16-byte aligned
// data; planes: scratch of 2·K·N floats (w split and transposed, the
// first of the call's three launches); part and sums as above. bn: columns
// of a y tile (64 or 128); stages: the ring's depth.
int dl4j_matmul_stats_tf32x3(const void* x, const void* w, void* planes,
                             void* y, void* part, void* sums, int M, int K,
                             int N, int bn, int stages, void* stream) {
  return tf3::dispatch<false>(x, w, planes, y, part, sums, M, K, N, 1, 1,
                              bn, stages,
                              static_cast<cudaStream_t>(stream));
}

// Design 3 of B7b: x [B, H, W, C], w [3, 3, C, N], y [B, H, W, N]
// float32, C and N multiples of 4, W <= 63; planes 2·9·C·N floats.
int dl4j_conv3x3_stats_tf32x3(const void* x, const void* w, void* planes,
                              void* y, void* part, void* sums, int B, int H,
                              int W, int C, int N, int bn, int stages,
                              void* stream) {
  const int64_t M = (int64_t)B * H * W;
  if (B < 1 || H < 1 || W < 1 || M > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  return tf3::dispatch<true>(x, w, planes, y, part, sums, (int)M, C, N, H,
                             W, bn, stages,
                             static_cast<cudaStream_t>(stream));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
