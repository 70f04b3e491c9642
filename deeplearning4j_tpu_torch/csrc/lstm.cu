// Fused LSTM sequence kernels for Hopper (sm_90a), float32 and bfloat16.
//
//   lstm_fwd_kernel<true>  — replaces the TPU kernel B2a,
//     deeplearning4j_tpu/ops/lstm.py `_fwd_kernel`: the recurrence over all
//     T steps with the residuals the backward needs (hs, cs, the activated
//     gates) and the final carries hT, cT.
//   lstm_fwd_kernel<false> — replaces B2b, `_fwd_kernel_inference`: the
//     same recurrence, writing hs, hT and cT only.
//   persist::lstm_fwd_persistent_kernel<BR, RESID> — design 2 of B2a
//     (RESID) and B2b, below.
//   lstm_bwd_kernel + lstm_drw_kernel + lstm_dp_reduce_kernel — replace
//     B2c, `_bwd_kernel`: reverse time, dxw, dh0, dc0, then dRW and dP.
//   persist::lstm_bwd_persistent_kernel<BR> and
//     pipe::lstm_drw_pipelined_kernel — design 2 of B2c's two launches
//     (ops/lstm.py `b2c_design`), below the forward's design 2.
//   persist::lstm_fwd_persistent_bf16_kernel<BR, RESID> — design 2 of
//     B2a and B2b in bfloat16, the float32 design 2 with its product on
//     the tensor cores (`mma.sync`), below the float32 one.
//   persist::lstm_bwd_persistent_bf16_kernel<BR> — design 2 of B2c's
//     recurrence in bfloat16: the float32 design 2's grid and exchange
//     with a bfloat16 strip of RW and the product on `mma.sync`, below
//     the float32 backward's design 2.
//   wg::lstm_drw_wgmma_kernel — design 2 of B2c's weight launch in
//     bfloat16: dRW on the tensor cores (`wgmma` fed by TMA), last.
//
// One step (gate order i, f, g, o; sigmoid gates, tanh cell; peepholes p,
// zeros disable them):
//     z  = xw[t] + h @ RW
//     i  = sigmoid(z_i + c p0)      f = sigmoid(z_f + c p1)
//     g  = tanh(z_g)                c' = f c + i g
//     o  = sigmoid(z_o + c' p2)     h' = o tanh(c')
//     h  = m h' + (1 - m) h         c  = m c' + (1 - m) c     (m = mask[t])
//
// Design. The TPU kernels are a sequential grid over T with h and c in
// scratch memory; CUDA has no sequential grid. The rows of the batch are
// independent recurrences, so a CLUSTER of kCluster thread blocks takes a
// tile of kBT batch rows and walks all T itself, and no cluster waits on
// another. Inside the cluster RW's columns are split: block r owns the
// hidden columns [r Hc, (r+1) Hc) and with them the four gate columns j,
// H+j, 2H+j, 3H+j of each. Every step it streams its strip of RW (1/8 of
// it) from L2 through a ring of shared-memory stages filled by cp.async,
// which keeps ~100 KB of loads in flight without holding registers and
// never drains, because the strip does not depend on h. A thread sums 4
// columns of the strip against the tile's 8 rows of h over every Q-th row
// of the strip (32 sums from 4 weight loads and two float4 loads of h a
// row: shared-memory bandwidth, not FFMA, is what the loop runs out of),
// and the Q threads of a column group, neighbouring lanes, add their
// shares with shuffles. Forward the 4 columns are the 4 gates of one
// hidden column, so thread (jj, q) holds all of column jj's pre-activations
// and does the gate math and the mask blend for rows 2q and 2q+1, keeps
// their c in registers, and writes their new h into EVERY block's next-h
// buffer through distributed shared memory. One cluster barrier a step.
// The backward block carries dh and dc in registers the same way, rebuilds
// the pre-activation gradients from the stored gates, writes dxw[t], pushes
// them into every block's shared memory, and forms its columns of dgates @
// RW^T from a strip of a transposed copy of RW with the same streaming
// loop (two cluster barriers a step). dRW = [h0; hs[:-1]]^T dxw over the
// T·B axis and dP's three column sums do not cross time, so a second launch
// computes them after the recurrence: a 128x64-tile SGEMM in fixed order and
// a fixed-order sum of each cluster's dP partial. No atomics: the results
// do not change from run to run.
//
// Bound. B·H·4H·T multiply-adds for each of the three products (h RW,
// dgates RW^T, hprev^T dxw) over the card's 67 TFLOP/s float32 rate
// exceed the bytes bound (xw in, hs/cs/gates out) at the training shapes.
// What this design pays instead: every cluster re-reads RW (4 MiB at H 512)
// from L2 each step, and at most 8 clusters are resident at once.
//
// Design 2 of the forward (B2a, and B2b where ops/lstm.py `b2_design`
// sends it), `persist::lstm_fwd_persistent_kernel`: RW does not fit one
// cluster even at H 512 (4 MiB), so the grid is persistent, one block an SM,
// launched cooperatively so that all its blocks are resident or the launch
// fails. Block (s, r) owns HC hidden columns (their four gate columns of RW,
// staged once into shared memory and resident for all T steps) and a tile
// of BR batch rows, with BR x 4 HC = 1024 pre-activations (`b2_rows` picks
// the smallest BR whose grid and shared memory fit, so that a step moves
// the least of h). Each step the block copies its BR rows of h_{t-1} from a
// double-buffered global h (k-major, through L2 only), its 8 warps each sum
// an eighth of K for all 1024 outputs (a lane 8 rows x 4 gates: 32 FFMA
// from three 16-byte shared loads), the partials are added in warp order,
// a thread does the cell of one (row, column) with c in a register and
// writes h_t, and the blocks of a batch tile pass one barrier (a counter,
// release and acquire). No atomics on data: two launches are bit-equal.
//
// Numerics. expf and tanhf, no fast-math: 128 steps of drift would break
// the tolerance. A sum of H products is taken as Q interleaved partial
// sums; the plain version's matmul sums in another order.
//
// bfloat16. Every tensor is read and written as bfloat16 except, in
// design 1, RW, which the wrapper widens to float32 once a call (as the
// backward already takes a transposed copy), and dP's per-cluster
// partials, float32 scratch. The math is float32 and rounds to bfloat16
// (`rnd<E>`) after each operation of the cell, as the Pallas body
// evaluated by XLA does: the recurrent product is rounded, then added to
// xw[t]; sigmoid is 1 / (1 + exp(-x)), each of its three operations
// rounded; h and c are carried rounded. So a kernel differs from the
// plain version only where a float32 sum in another order, or expf/tanhf
// against the host's, lands on the other side of a bfloat16 rounding. dRW
// and dP are float32 sums rounded once, where the Pallas kernel keeps a
// running bfloat16 sum over T: contract C13 (ROADMAP §C) bounds the
// difference. ops/lstm.py `b2_design`, `b2c_design` and
// `b2c_weights_design` choose by shape, as for float32.
//
// Design 2 of the bfloat16 forward (`persist::lstm_fwd_persistent_bf16_
// kernel`) keeps the float32 design 2's grid, resident strip, double-
// buffered h in global memory and counter barrier, and replaces design
// 1's strip of float32 RW streamed from L2 every step (the cluster kernel
// ran at 0.9% of its bound, slower than cuDNN). Bound: the same as
// float32's, B·H·4H·T multiply-adds, now at the bfloat16 tensor-core
// rate, against xw in and hs, cs, gates out. The strip is bfloat16, half
// float32's bytes, so at H 512 a block of 8 batch rows (128 gate columns,
// 130 KB of strip) fits, and a step copies 8 KB of h where float32's
// 16-row tile copies 32 KB. A
// step's product is 128 x 8 x H, too small for `wgmma`'s 64-row tiles to
// pay for their warpgroup fences and descriptors: each warp runs
// `mma.sync` m16n8k16 on one 16 x 8 tile over all of K, four accumulator
// chains deep, so the step waits on H / 64 dependent products and not on
// the tensor cores' rate. What bounds a step is its latency: the h copy,
// the product, the cell, the barrier.
//
// Design 2 of the bfloat16 recurrence (`persist::lstm_bwd_persistent_
// bf16_kernel`) does the same for B2c's reverse-time step, replacing
// design 1's float32 copy of RW^T streamed from L2 every step by 64
// blocks: the strip stays resident in bfloat16, as RW lies (the A operand
// of `mma.sync` with k as M), the step's BR x H partial of dgates RW^T
// runs on the tensor cores, and the partials meet through L2 at one
// counter barrier a step. A step is latency: the cell, the product, the
// barrier, the exchange.
//
// Design 2 of the bfloat16 weight product (`wg::lstm_drw_wgmma_kernel`)
// replaces design 1's float32 FFMA on 2-byte loads (`lstm_drw_kernel`,
// 61.7x slower than one bfloat16 `torch.matmul`). Bound: 2·T·B·H·4H flops
// at the bfloat16 tensor-core rate (17.2 GFLOP, 0.0174 ms at path_l's
// shape) against hs, dxw in and dRW out. Only 32 tiles of 128 x 256 cover
// dRW at H 512, so K = T·B is split into slices (`b2c_wgmma_splits`), the
// slices of a tile one cluster that adds its float32 sums in distributed
// shared memory, so that no partial leaves the SMs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;          // blocks a cluster: RW's column split
constexpr int kBT = 8;               // batch rows a cluster (two float4)
constexpr int kMaxThreads = 512;     // 4 threads a hidden column, 128 columns
constexpr int kStageFloats = 8448;   // ~33 KB of RW a pipeline stage
constexpr int kMaxStages = 4;
constexpr int kSmemFloats = 232448 / 4;   // what a block can ask for

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Design 1's element types. Loads widen to float32 and stores round to E;
// the math is float32, and rnd<E> rounds a result to E where the Pallas
// body holds it in E (bfloat16: after every operation, as XLA evaluates
// the interpreted body and the plain version's bfloat16 tensors do;
// float32: nothing).
template <typename E> struct Elt;
template <> struct Elt<float> {
  static __device__ __forceinline__ float ld(float x) { return x; }
  static __device__ __forceinline__ float st(float x) { return x; }
};
template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 st(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename E>
__device__ __forceinline__ float ldf(const E* a, size_t i) {
  return Elt<E>::ld(a[i]);
}

template <typename E>
__device__ __forceinline__ float rnd(float x) {
  return Elt<E>::ld(Elt<E>::st(x));
}

// sigm with each of its three operations rounded to E
template <typename E>
__device__ __forceinline__ float sigm_r(float x) {
  return rnd<E>(1.0f / rnd<E>(1.0f + rnd<E>(expf(-x))));
}

// How a block's threads and shared memory are cut for a hidden size.
struct Geom {
  int Hc;        // hidden columns a block owns
  int Hcp;       // Hc rounded up to a warp; the block has 4 Hcp threads
  int vec;       // 1: 16-byte copies are aligned (H and Hc multiples of 4)
  int P;         // floats a staged row of the strip takes (padded)
  int KT;        // rows of the strip a stage holds
};

// segs: the strip's column segments a row (4 gates forward, 1 backward)
Geom geometry(int H, int segs) {
  Geom q;
  q.Hc = (H + kCluster - 1) / kCluster;
  q.vec = H % 4 == 0;
  if (q.vec) q.Hc = (q.Hc + 3) / 4 * 4;
  q.Hcp = (q.Hc + 31) / 32 * 32;
  // the pad skews the rows that the lanes of a warp read at once across
  // the banks: 4 rows x 8 columns forward, 16 rows x 2 columns backward
  q.P = segs * q.Hcp + (segs == 4 ? 8 : 4);
  q.KT = kStageFloats / q.P / 16 * 16;
  return q;
}

// Streams one block's strip of a weight matrix, tile after tile, through
// the ring of stages, and multiplies it with the tile's rows. The strip
// has `rows` rows of `segs` segments of wcols columns: element (r, s, c)
// is W[r * sk + s * sg + c] (RW itself forward: rows k, the 4 gate
// segments; RW transposed backward: rows n = (gate, k), one segment). A
// stage holds KT rows as [KT][P], segment s at column s * Hcp.
struct Stream {
  const float* W;
  size_t sk, sg;
  float* w_s;
  int rows, segs, Hcp, P, KT, vec, wcols, ntiles, stages;
  long long total;     // tiles over all T steps
  // the producer's and the consumer's place in the tile sequence, kept by
  // counting (no division in the loops)
  long long fetched;
  int i_tile, i_stage, c_stage;
  // this thread's share of a tile's copies: one 16-byte (or 4-byte) unit
  // of every `r_step`-th row from `r_sub` on
  int r_sub, r_step, u_seg, u_col;
  bool copies;
  // its share of the sums: columns cg + i * cstride (i < 4) of every Q-th
  // row from q on
  int Q, q, cg, cstride;

  __device__ __forceinline__ void init() {
    fetched = 0;
    i_tile = i_stage = c_stage = 0;
    const int width = vec ? 4 : 1;
    const int per_seg = Hcp / width, per_row = segs * per_seg;
    const int u = threadIdx.x % per_row;
    r_sub = threadIdx.x / per_row;
    r_step = blockDim.x / per_row;
    u_seg = u / per_seg;
    u_col = (u % per_seg) * width;
    copies = u_col < wcols;
    cstride = segs * Hcp / 4;
    Q = blockDim.x / cstride;
    q = threadIdx.x % Q;
    cg = threadIdx.x / Q;
  }

  __device__ __forceinline__ void fetch() {
    if (fetched < total) {
      const int r0 = i_tile * KT;
      const int rn = min(KT, rows - r0);
      if (copies) {
        float* dst = w_s + (size_t)i_stage * KT * P + r_sub * P
            + u_seg * Hcp + u_col;
        const float* src = W + (size_t)(r0 + r_sub) * sk + u_seg * sg + u_col;
        if (vec) {
          for (int r = r_sub; r < rn; r += r_step) {
            __pipeline_memcpy_async(dst, src, 16);
            dst += r_step * P;
            src += r_step * sk;
          }
        } else {
          for (int r = r_sub; r < rn; r += r_step) {
            __pipeline_memcpy_async(dst, src, 4);
            dst += r_step * P;
            src += r_step * sk;
          }
        }
      }
      ++fetched;
      if (++i_tile == ntiles) i_tile = 0;
      if (++i_stage == stages) i_stage = 0;
    }
    __pipeline_commit();
  }

  // One whole pass over the strip (the next ntiles tiles): acc[i][b] =
  // sum over the strip's rows r of v[r][b] * W[r, column cg + i cstride],
  // complete in every thread of the column group. Row r of v is the
  // float4 va[r] (batch rows 0-3) and the float4 vb[r] (rows 4-7).
  __device__ __forceinline__ void pass(const float4* va, const float4* vb,
                                       float (&acc)[4][kBT]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < kBT; ++b) acc[i][b] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      __pipeline_wait_prior(stages - 2);
      __syncthreads();          // this tile has landed; the last is consumed
      fetch();
      const int r0 = t * KT;
      const int rn = min(KT, rows - r0);
      const float* ws = w_s + (size_t)c_stage * KT * P + cg;
      if (++c_stage == stages) c_stage = 0;
#pragma unroll 2
      for (int r = q; r < rn; r += Q) {
        const float* wr = ws + r * P;
        const float w[4] = {wr[0], wr[cstride], wr[2 * cstride],
                            wr[3 * cstride]};
        const float4 a = va[r0 + r], b = vb[r0 + r];
        const float v[kBT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int bb = 0; bb < kBT; ++bb)
            acc[i][bb] = fmaf(v[bb], w[i], acc[i][bb]);
      }
    }
    // the column group's Q threads are neighbouring lanes
    for (int d = 1; d < Q; d <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < kBT; ++b)
          acc[i][b] += __shfl_xor_sync(0xffffffffu, acc[i][b], d);
  }
};

// rows 2 rp and 2 rp + 1 of an [..][kBT] accumulator, by selection (a
// computed index would send the array to local memory)
__device__ __forceinline__ float pick(const float (&a)[kBT], int rp, int pi) {
  const float lo = rp < 2 ? (rp == 0 ? a[0 + pi] : a[2 + pi])
                          : (rp == 2 ? a[4 + pi] : a[6 + pi]);
  return lo;
}

// where batch row b of strip row r lives in a [2][rows][4] buffer
__device__ __forceinline__ size_t vat(int rows, int r, int b) {
  return ((size_t)(b >> 2) * rows + r) * 4 + (b & 3);
}

// ------------------------------------------------------------------ forward
// E: the element type of every tensor but rw, which the wrapper hands over
// in float32 (a widened copy for bfloat16), so the streamed strip is the
// same float32 pipeline in both.
template <typename E, bool RESID>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const E* __restrict__ xw, const float* __restrict__ rw,
                const E* __restrict__ p, const E* __restrict__ h0,
                const E* __restrict__ c0, const E* __restrict__ mask,
                E* __restrict__ hs, E* __restrict__ cs,
                E* __restrict__ gates, E* __restrict__ hT,
                E* __restrict__ cT, int T, int B, int H, Geom geo,
                int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* h_buf[2] = {smem, smem + (size_t)H * kBT};   // [2][H][4] each
  const int Hcp = geo.Hcp, H4 = 4 * H;
  const int b0 = blockIdx.y * kBT;
  // thread (jj, rp) owns rows 2 rp and 2 rp + 1 of hidden column j
  const int jj = threadIdx.x >> 2, rp = threadIdx.x & 3;
  const int j0 = rank * geo.Hc;
  const int wcols = max(0, min(geo.Hc, H - j0));
  const int j = j0 + jj;
  const bool col_ok = jj < wcols;

  Stream st;
  st.W = rw + j0;
  st.sk = (size_t)H4;
  st.sg = (size_t)H;
  st.w_s = smem + (size_t)2 * H * kBT;
  st.rows = H; st.segs = 4; st.Hcp = Hcp; st.P = geo.P; st.KT = geo.KT;
  st.vec = geo.vec; st.wcols = wcols; st.stages = stages;
  st.ntiles = (H + geo.KT - 1) / geo.KT;
  st.total = (long long)T * st.ntiles;
  st.init();
  for (int s = 0; s < stages - 1; ++s) st.fetch();

  // every block holds the whole h of the tile
  for (int k = threadIdx.x; k < H; k += blockDim.x)
#pragma unroll
    for (int b = 0; b < kBT; ++b)
      h_buf[0][vat(H, k, b)] =
          b0 + b < B ? ldf(h0, (size_t)(b0 + b) * H + k) : 0.f;
  float c_reg[2], h_reg[2];
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int row = b0 + 2 * rp + pi;
    const bool ok = col_ok && row < B;
    c_reg[pi] = ok ? ldf(c0, (size_t)row * H + j) : 0.f;
    h_reg[pi] = ok ? ldf(h0, (size_t)row * H + j) : 0.f;
  }
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (col_ok) {
    p0 = ldf(p, j);
    p1 = ldf(p, H + j);
    p2 = ldf(p, 2 * H + j);
  }
  cluster.sync();     // every block of the cluster runs and holds h0

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    // this step's inputs for the two rows, in flight during the pass
    float xv[2][4], m[2];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const int row = b0 + 2 * rp + pi;
      const bool ok = col_ok && row < B;
      m[pi] = ok ? ldf(mask, (size_t)t * B + row) : 0.f;
      const E* x = xw + ((size_t)t * B + (ok ? row : 0)) * H4
          + (ok ? j : 0);
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
        xv[pi][gg] = ok ? Elt<E>::ld(x[gg * H]) : 0.f;
    }
    float acc[4][kBT];      // [gate][batch row] of column jj
    const float4* hv = reinterpret_cast<const float4*>(h_buf[cur]);
    st.pass(hv, hv + H, acc);

    float* h_nxt = h_buf[cur ^ 1];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const int row = b0 + 2 * rp + pi;
      // the product is emitted in E, then added to xw[t]
      const float zi = rnd<E>(rnd<E>(pick(acc[0], rp, pi)) + xv[pi][0]);
      const float zf = rnd<E>(rnd<E>(pick(acc[1], rp, pi)) + xv[pi][1]);
      const float zg = rnd<E>(rnd<E>(pick(acc[2], rp, pi)) + xv[pi][2]);
      const float zo = rnd<E>(rnd<E>(pick(acc[3], rp, pi)) + xv[pi][3]);
      const float cp = c_reg[pi], hp = h_reg[pi], mm = m[pi];
      const float ig = sigm_r<E>(rnd<E>(zi + rnd<E>(cp * p0)));
      const float fg = sigm_r<E>(rnd<E>(zf + rnd<E>(cp * p1)));
      const float gg = rnd<E>(tanhf(zg));
      const float c_new = rnd<E>(rnd<E>(fg * cp) + rnd<E>(ig * gg));
      const float og = sigm_r<E>(rnd<E>(zo + rnd<E>(c_new * p2)));
      const float h_new = rnd<E>(og * rnd<E>(tanhf(c_new)));
      const float keep = rnd<E>(1.0f - mm);
      const float hn = rnd<E>(rnd<E>(mm * h_new) + rnd<E>(keep * hp));
      const float cn = rnd<E>(rnd<E>(mm * c_new) + rnd<E>(keep * cp));
      c_reg[pi] = cn;
      h_reg[pi] = hn;
      if (col_ok && row < B) {
        const size_t at = ((size_t)t * B + row) * H + j;
        hs[at] = Elt<E>::st(hn);
        if (RESID) {
          cs[at] = Elt<E>::st(cn);
          E* gt = gates + ((size_t)t * B + row) * H4 + j;
          gt[0] = Elt<E>::st(ig);
          gt[H] = Elt<E>::st(fg);
          gt[2 * H] = Elt<E>::st(gg);
          gt[3 * H] = Elt<E>::st(og);
        }
      }
    }
    if (col_ok) {       // both rows' new h into every block's next buffer
      const float2 h2 = make_float2(h_reg[0], h_reg[1]);
      const size_t at = vat(H, j, 2 * rp);
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(h_nxt, r) + at)
            = h2;
    }
    cluster.sync();     // the next h is complete in every block
    cur ^= 1;
  }

#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int row = b0 + 2 * rp + pi;
    if (col_ok && row < B) {
      hT[(size_t)row * H + j] = Elt<E>::st(h_reg[pi]);
      cT[(size_t)row * H + j] = Elt<E>::st(c_reg[pi]);
    }
  }
}

// ----------------------------------------------------------------- backward
// what the cell of (b, j) reads at step t: the gates, c_t, c_{t-1} (c0 at
// t = 0), the output's cotangent and the mask; zeros outside the shape
struct Resid {
  float i, f, g, o, c, cp, dho, m;
};

// One cell's step of the backward: from the residuals r and the carried
// dh and dc, the gate gradients dg (i, f, g, o), the next dc, the step's
// peephole terms added into dpa; returns the mask's pass-through of dh.
// Each operation is rounded to E in the order the plain version
// (lstm_bwd_plain) writes it; in float32 rnd is nothing.
template <typename E>
__device__ __forceinline__ float cell_bwd(const Resid& r, float dh,
                                          float& dc, float p0, float p1,
                                          float p2, float (&dg)[4],
                                          float (&dpa)[3]) {
  const float keep = rnd<E>(1.0f - r.m);
  const float dh_in = rnd<E>(r.dho + dh);
  const float dh_t = rnd<E>(r.m * dh_in);
  const float pass_h = rnd<E>(keep * dh_in);
  const float tanh_c = rnd<E>(tanhf(r.c));
  const float do_pre = rnd<E>(rnd<E>(rnd<E>(dh_t * tanh_c) * r.o)
                              * rnd<E>(1.0f - r.o));
  const float dc_new = rnd<E>(
      rnd<E>(rnd<E>(r.m * dc)
             + rnd<E>(rnd<E>(dh_t * r.o)
                      * rnd<E>(1.0f - rnd<E>(tanh_c * tanh_c))))
      + rnd<E>(do_pre * p2));
  const float di_pre = rnd<E>(rnd<E>(rnd<E>(dc_new * r.g) * r.i)
                              * rnd<E>(1.0f - r.i));
  const float df_pre = rnd<E>(rnd<E>(rnd<E>(dc_new * r.cp) * r.f)
                              * rnd<E>(1.0f - r.f));
  const float dg_pre = rnd<E>(rnd<E>(dc_new * r.i)
                              * rnd<E>(1.0f - rnd<E>(r.g * r.g)));
  dc = rnd<E>(rnd<E>(rnd<E>(rnd<E>(dc_new * r.f) + rnd<E>(keep * dc))
                     + rnd<E>(di_pre * p0))
              + rnd<E>(df_pre * p1));
  dpa[0] += di_pre * r.cp;
  dpa[1] += df_pre * r.cp;
  dpa[2] += do_pre * r.c;
  dg[0] = di_pre;
  dg[1] = df_pre;
  dg[2] = dg_pre;
  dg[3] = do_pre;
  return pass_h;
}

// rwT is RW transposed, [4H, H], float32 for every E; dp_part is float32
// [batch tiles, 3, H], one partial of dP a cluster, summed afterwards in
// tile order. In bfloat16 the step's arithmetic rounds where the Pallas
// body's does; dP's partials stay float32 (contract C13, ops/lstm.py).
template <typename E>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
lstm_bwd_kernel(const E* __restrict__ dhs, const E* __restrict__ gates,
                const E* __restrict__ cs, const float* __restrict__ rwT,
                const E* __restrict__ p, const E* __restrict__ mask,
                const E* __restrict__ dhT, const E* __restrict__ dcT,
                const E* __restrict__ c0, E* __restrict__ dxw,
                E* __restrict__ dh0, E* __restrict__ dc0,
                float* __restrict__ dp_part, int T, int B, int H, Geom geo,
                int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Hcp = geo.Hcp, H4 = 4 * H;
  float* dg_s = smem;                                 // [2][4H][4]
  float* z_s = smem + (size_t)H4 * kBT;               // [Hcp][kBT]
  const int b0 = blockIdx.y * kBT;
  // thread (jj, rp) owns rows 2 rp and 2 rp + 1 of hidden column j
  const int jj = threadIdx.x >> 2, rp = threadIdx.x & 3;
  const int j0 = rank * geo.Hc;
  const int wcols = max(0, min(geo.Hc, H - j0));
  const int j = j0 + jj;
  const bool col_ok = jj < wcols;

  Stream st;
  st.W = rwT + j0;
  st.sk = (size_t)H;
  st.sg = 0;
  st.w_s = z_s + (size_t)Hcp * kBT;
  st.rows = H4; st.segs = 1; st.Hcp = Hcp; st.P = geo.P; st.KT = geo.KT;
  st.vec = geo.vec; st.wcols = wcols; st.stages = stages;
  st.ntiles = (H4 + geo.KT - 1) / geo.KT;
  st.total = (long long)T * st.ntiles;
  st.init();
  for (int s = 0; s < stages - 1; ++s) st.fetch();

  float dh_reg[2], dc_reg[2], dpa[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int row = b0 + 2 * rp + pi;
    const bool ok = col_ok && row < B;
    dh_reg[pi] = ok ? ldf(dhT, (size_t)row * H + j) : 0.f;
    dc_reg[pi] = ok ? ldf(dcT, (size_t)row * H + j) : 0.f;
  }
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (col_ok) {
    p0 = ldf(p, j);
    p1 = ldf(p, H + j);
    p2 = ldf(p, 2 * H + j);
  }
  cluster.sync();     // every block of the cluster runs

  for (int t = T - 1; t >= 0; --t) {
    // phase 1: the gate gradients of rows 2 rp and 2 rp + 1 of column j,
    // written to dxw and pushed into every block's dg_s
    float pass_h[2], dgate[4][2];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const int row = b0 + 2 * rp + pi;
      Resid r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const bool ok = col_ok && row < B;
      if (ok) {
        const size_t at = ((size_t)t * B + row) * H + j;
        const E* gt = gates + ((size_t)t * B + row) * H4 + j;
        r.i = Elt<E>::ld(gt[0]);
        r.f = Elt<E>::ld(gt[H]);
        r.g = Elt<E>::ld(gt[2 * H]);
        r.o = Elt<E>::ld(gt[3 * H]);
        r.c = ldf(cs, at);
        // the predecessor of step 0 is the initial carry
        r.cp = t == 0 ? ldf(c0, (size_t)row * H + j)
                      : ldf(cs, at - (size_t)B * H);
        r.dho = ldf(dhs, at);
        r.m = ldf(mask, (size_t)t * B + row);
      }
      float dg[4];
      pass_h[pi] = cell_bwd<E>(r, dh_reg[pi], dc_reg[pi], p0, p1, p2, dg,
                               dpa);
      if (ok) {
        E* dx = dxw + ((size_t)t * B + row) * H4 + j;
        dx[0] = Elt<E>::st(dg[0]);
        dx[H] = Elt<E>::st(dg[1]);
        dx[2 * H] = Elt<E>::st(dg[2]);
        dx[3 * H] = Elt<E>::st(dg[3]);
      }
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) dgate[gg][pi] = dg[gg];
    }
    if (col_ok) {
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        float* d = cluster.map_shared_rank(dg_s, r);
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
          *reinterpret_cast<float2*>(d + vat(H4, gg * H + j, 2 * rp)) =
              make_float2(dgate[gg][0], dgate[gg][1]);
      }
    }
    cluster.sync();     // dgates[t] is complete in every block

    // phase 2: dh_prev[k] = sum_n dgates[n] RW[k, n] + the held share; the
    // pass leaves 4 columns' sums with each column group, which hands them
    // to the columns' owners through z_s
    float acc[4][kBT];
    const float4* dv = reinterpret_cast<const float4*>(dg_s);
    st.pass(dv, dv + H4, acc);
    if (st.q == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < kBT; ++b)
          z_s[(st.cg + i * st.cstride) * kBT + b] = acc[i][b];
    }
    __syncthreads();
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
      dh_reg[pi] = rnd<E>(rnd<E>(z_s[jj * kBT + 2 * rp + pi]) + pass_h[pi]);
    cluster.sync();     // every block is done with dg_s and z_s
  }

#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int row = b0 + 2 * rp + pi;
    if (col_ok && row < B) {
      dh0[(size_t)row * H + j] = Elt<E>::st(dh_reg[pi]);
      dc0[(size_t)row * H + j] = Elt<E>::st(dc_reg[pi]);
    }
  }
  // the column's dP partial: its four threads are neighbouring lanes
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    dpa[q] += __shfl_xor_sync(0xffffffffu, dpa[q], 1);
    dpa[q] += __shfl_xor_sync(0xffffffffu, dpa[q], 2);
  }
  if (rp == 0 && col_ok) {
    float* dp = dp_part + (size_t)blockIdx.y * 3 * H + j;
    dp[0] = dpa[0];
    dp[H] = dpa[1];
    dp[2 * H] = dpa[2];
  }
}

// dRW[m, n] = sum_kk hprev[kk, m] dxw[kk, n], kk = t·B + b over T·B rows,
// hprev[t] = h0 at t = 0 and hs[t-1] after. A block owns a 128x64 tile of
// dRW and walks the T·B rows 16 at a time: the next 16 rows' loads are in
// flight (in registers) while the current 16, staged in shared memory, are
// multiplied, 8x4 outputs a thread; two stage buffers, one barrier a walk.
constexpr int kTileM = 128;
constexpr int kTileN = 64;
constexpr int kDepth = 16;

// E: hs, h0, dxw and drw; the sum is float32 and rounds once (in
// bfloat16 the Pallas kernel keeps a running sum in E: contract C13).
template <typename E>
__global__ void __launch_bounds__(256)
lstm_drw_kernel(const E* __restrict__ hs, const E* __restrict__ h0,
                const E* __restrict__ dxw, E* __restrict__ drw,
                int T, int B, int H) {
  __shared__ __align__(16) float a_s[2][kDepth][kTileM];
  __shared__ __align__(16) float b_s[2][kDepth][kTileN];
  const int H4 = 4 * H;
  const int64_t K = (int64_t)T * B;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int kA = kDepth * kTileM / 256, kB = kDepth * kTileN / 256;
  float ra[kA], rb[kB];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto load = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int idx = threadIdx.x + i * 256;
      const int64_t kk = k0 + idx / kTileM;
      const int m = m0 + idx % kTileM;
      ra[i] = (kk < K && m < H)
          ? (kk < B ? ldf(h0, kk * H + m) : ldf(hs, (kk - B) * H + m)) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int idx = threadIdx.x + i * 256;
      const int64_t kk = k0 + idx / kTileN;
      const int n = n0 + idx % kTileN;
      rb[i] = (kk < K && n < H4) ? ldf(dxw, kk * H4 + n) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int idx = threadIdx.x + i * 256;
      a_s[buf][idx / kTileM][idx % kTileM] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int idx = threadIdx.x + i * 256;
      b_s[buf][idx / kTileN][idx % kTileN] = rb[i];
    }
  };

  load(0);
  stage(0);
  __syncthreads();
  int cur = 0;
  for (int64_t k0 = 0; k0 < K; k0 += kDepth) {
    const bool more = k0 + kDepth < K;
    if (more) load(k0 + kDepth);
#pragma unroll
    for (int r = 0; r < kDepth; ++r) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&a_s[cur][r][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[cur][r][ty * 8 + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[cur][r][tx * 4]);
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
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mrow = m0 + ty * 8 + i;
    if (mrow >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ncol = n0 + tx * 4 + j;
      if (ncol < H4) drw[(size_t)mrow * H4 + ncol] = Elt<E>::st(acc[i][j]);
    }
  }
}

// dP[q, j] = the batch tiles' float32 partials summed in tile order,
// rounded once to E
template <typename E>
__global__ void lstm_dp_reduce_kernel(const float* __restrict__ dp_part,
                                      E* __restrict__ dp, int tiles,
                                      int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * H) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += dp_part[(size_t)t * 3 * H + i];
  dp[i] = Elt<E>::st(s);
}

bool bad_shape(int T, int B, int H) {
  return T < 1 || B < 1 || H < 1 || H > kCluster * (kMaxThreads / 4)
      || (B + kBT - 1) / kBT > 65535;
}

// stages of the ring that fit beside `fixed` floats of shared memory
int stages_for(int fixed) {
  const int s = (kSmemFloats - fixed) / kStageFloats;
  return s < kMaxStages ? s : kMaxStages;
}

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, bool* raised) {
  if (*raised) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemFloats * (int)sizeof(float));
  if (e == cudaSuccess) *raised = true;
  return e;
}

// ------------------------------------------------------ forward, design 2
// The persistent grid (see the top of this file). A block computes the
// pre-activations of a tile of BR batch rows x NC = 1024 / BR gate columns:
// HC = NC / 4 hidden columns, each with its four gates side by side.
namespace persist {

constexpr int kThreads = 256;   // 8 warps; warp w sums the w-th eighth of K
constexpr int kWarps = kThreads / 32;

template <int BR>
struct Tile {
  static constexpr int NC = 1024 / BR;   // gate columns
  static constexpr int HC = NC / 4;      // hidden columns (and a warp's
                                         // column groups: BR / 8 x HC = 32)
  static constexpr int NCP = NC + 4;     // padded row of the partial sums
};

// floats of shared memory: the resident strip [H][NC], then the h tile
// [H][BR], whose space the warps' partial sums [kWarps][BR][NCP] reuse
template <int BR>
__host__ __device__ constexpr size_t smem_floats(int H) {
  using G = Tile<BR>;
  const size_t h = (size_t)H * BR, red = (size_t)kWarps * BR * G::NCP;
  return (size_t)H * G::NC + (h > red ? h : red);
}

__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src) {
  // .cg: through L2 only, never a stale L1 line of an earlier step's h
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The blocks of one batch tile (gridDim.x of them) wait for each other: a
// counter that only grows, `target` its value once this barrier is done.
// Release: the block's writes, then one arrival; acquire: the spin, then a
// fence. A spin past ~2^35 cycles traps instead of hanging the card.
__device__ __forceinline__ void tile_barrier(unsigned* counter,
                                             unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen;
    long long start = 0;
    for (;;) {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      if (start == 0) start = clock64();
      else if (clock64() - start > (1LL << 35)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The arguments of `dl4j_lstm_fwd_persistent`: hbuf [2][H][Bp] (Bp =
// gridDim.y BR) carries h between steps, k-major so that a block's tile of
// it is BR contiguous floats a row; counters [gridDim.y] start at 0.
struct Args {
  const float *xw, *rw, *p, *h0, *c0, *mask;
  float *hs, *cs, *gates, *hT, *cT, *hbuf;
  unsigned* counters;
  int T, B, H;
};

// Block (s, r): hidden columns j0 = s HC .., batch rows b0 = r BR ..
template <int BR, bool RESID>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_persistent_kernel(const Args a) {
  using G = Tile<BR>;
  const float* __restrict__ xw = a.xw;
  const float* __restrict__ mask = a.mask;
  float* hbuf = a.hbuf;
  const int T = a.T, B = a.B, H = a.H;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);    // [H][NC]
  float* hsm = ws + (size_t)H * G::NC;            // [H][BR] / partials
  const int j0 = blockIdx.x * G::HC, b0 = blockIdx.y * BR;
  const int Bp = gridDim.y * BR, H4 = 4 * H;
  unsigned* counter = a.counters + blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the product: lane (rg, cgrp) sums rows 4 rg + i and BR / 2 + 4 rg + i
  // (i < 4) against gate columns 4 cgrp .. + 3 over K rows [k0, k1)
  const int rg = lane / G::HC, cgrp = lane % G::HC;
  const int kw = (H + kWarps - 1) / kWarps;
  const int k0 = min(H, warp * kw), k1 = min(H, k0 + kw);
  // the cell: thread (row, jj) owns batch row b and hidden column j
  const int row = threadIdx.x / G::HC, jj = threadIdx.x % G::HC;
  const int b = b0 + row, j = j0 + jj;
  const bool col_ok = j < H, row_ok = b < B;

  // RW's strip, resident for the whole sequence: ws[k][4 jj + g] =
  // RW[k][g H + j0 + jj], zeros past H
  for (int idx = threadIdx.x; idx < H * G::NC; idx += kThreads) {
    const int k = idx / G::NC, c = idx % G::NC;
    const int g = c / G::HC, cj = j0 + c % G::HC;
    ws[k * G::NC + 4 * (c % G::HC) + g] =
        cj < H ? a.rw[(size_t)k * H4 + g * H + cj] : 0.f;
  }
  float c_reg = 0.f, h_reg = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (col_ok && row_ok) {
    c_reg = a.c0[(size_t)b * H + j];
    h_reg = a.h0[(size_t)b * H + j];
  }
  if (col_ok) {
    p0 = a.p[j];
    p1 = a.p[H + j];
    p2 = a.p[2 * H + j];
    hbuf[(size_t)j * Bp + b] = h_reg;    // rows past B carry zeros
  }
  unsigned target = 0;
  tile_barrier(counter, target);         // h0 is complete in hbuf[0]

  for (int t = 0; t < T; ++t) {
    // this step's inputs for the cell, in flight during the product
    float xv[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.f;
    if (col_ok && row_ok) {
      const float* x = xw + ((size_t)t * B + b) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g] = __ldg(x + g * H);
      m = __ldg(mask + (size_t)t * B + b);
    }
    // h_{t-1}'s tile: hsm[k][i] = hbuf[t & 1][k][b0 + i]
    const float* hin = hbuf + (size_t)(t & 1) * H * Bp + b0;
    for (int idx = threadIdx.x; idx < H * (BR / 4); idx += kThreads) {
      const int k = idx / (BR / 4), q = idx % (BR / 4);
      cp_async16_cg(hsm + k * BR + 4 * q, hin + (size_t)k * Bp + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 ha = *reinterpret_cast<const float4*>(hsm + k * BR +
                                                         4 * rg);
      const float4 hb = *reinterpret_cast<const float4*>(
          hsm + k * BR + BR / 2 + 4 * rg);
      const float4 w4 = *reinterpret_cast<const float4*>(ws + k * G::NC +
                                                         4 * cgrp);
      const float hv[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = fmaf(hv[i], wv[g], acc[i][g]);
    }
    __syncthreads();     // every warp is done with the h tile
    float* red = hsm;    // [kWarps][BR][NCP]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = (i < 4 ? 0 : BR / 2) + 4 * rg + (i & 3);
      *reinterpret_cast<float4*>(red + ((size_t)warp * BR + rr) * G::NCP +
                                 4 * cgrp) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    // the cell: the warps' partial sums added in warp order
    float z[4] = {xv[0], xv[1], xv[2], xv[3]};
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(
            red + ((size_t)w * BR + row) * G::NCP + 4 * jj);
        s[0] += v.x;
        s[1] += v.y;
        s[2] += v.z;
        s[3] += v.w;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) z[g] = s[g] + z[g];
    }
    const float ig = sigm(z[0] + c_reg * p0);
    const float fg = sigm(z[1] + c_reg * p1);
    const float gg = tanhf(z[2]);
    const float c_new = fg * c_reg + ig * gg;
    const float og = sigm(z[3] + c_new * p2);
    const float h_new = og * tanhf(c_new);
    h_reg = m * h_new + (1.0f - m) * h_reg;
    c_reg = m * c_new + (1.0f - m) * c_reg;
    if (col_ok) {
      if (row_ok) {
        const size_t at = ((size_t)t * B + b) * H + j;
        a.hs[at] = h_reg;
        if (RESID) {
          a.cs[at] = c_reg;
          float* gt = a.gates + ((size_t)t * B + b) * H4 + j;
          gt[0] = ig;
          gt[H] = fg;
          gt[2 * H] = gg;
          gt[3 * H] = og;
        }
      }
      hbuf[(size_t)((t + 1) & 1) * H * Bp + (size_t)j * Bp + b] = h_reg;
    }
    tile_barrier(counter, target);   // h_t is complete in hbuf
  }
  if (col_ok && row_ok) {
    a.hT[(size_t)b * H + j] = h_reg;
    a.cT[(size_t)b * H + j] = c_reg;
  }
}

template <int BR, bool RESID>
cudaError_t launch(Args a, cudaStream_t st) {
  using G = Tile<BR>;
  auto kernel = lstm_fwd_persistent_kernel<BR, RESID>;
  const size_t smem = sizeof(float) * smem_floats<BR>(a.H);
  if (smem > (size_t)kSmemFloats * sizeof(float)) return cudaErrorInvalidValue;
  static bool raised = false;
  cudaError_t e = raise_smem_limit(kernel, &raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.H + G::HC - 1) / G::HC, (a.B + BR - 1) / BR);
  // every block must be resident at once: the cooperative launch refuses
  // (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be, rather
  // than letting the barriers wait forever
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                     dim3(kThreads), args, smem, st);
}

// ------------------------------------------- forward, design 2, bfloat16
// The float32 design's grid, barrier and cell in bfloat16, with the
// product on the tensor cores (see the top of this file). Block (s, r)
// owns HC = 256 / BR hidden columns and BR batch rows; its strip of RW
// (NC = 4 HC gate columns, gates side by side as in float32) is staged
// once, TRANSPOSED and in bfloat16: ws[4 jc + g][k] = RW[k][g H + j0 +
// jc], K running along a row, so that it is the row-major A operand of
// `mma.sync` m16n8k16 (gate columns as M) and h's tile, [BR][K] as h
// lies, the column-major B (batch rows as N). The NC x BR outputs are
// 8 tiles of 16 x 8 whatever BR is: warp w takes tile w over all of K,
// with four accumulators (k16 step s into d[s % 4]) added in order at the
// end, so a step's chain is H / 64 products long. Fragments come from
// shared memory by `ldmatrix`; a staged row is K padded to 16 plus 8
// elements, so the 8 rows an `ldmatrix` reads lie in 8 different bank
// groups. K is padded with zeros in the strip and in h.
template <int BR>
struct TileBf16 {
  static constexpr int NC = 1024 / BR;   // gate columns
  static constexpr int HC = NC / 4;      // hidden columns
  static constexpr int MT = NC / 16;     // the product's 16-column tiles
};

// K padded to the product's depth, and a staged row's length (elements)
__host__ __device__ constexpr int bf16_hk(int H) { return (H + 15) / 16 * 16; }
__host__ __device__ constexpr int bf16_row(int H) { return bf16_hk(H) + 8; }

// bytes of shared memory: the strip [NC][row], h's tile [BR][row], and
// the rounded products zs [BR][NC] float32 (ops/lstm.py `b2_rows` with
// esize 2 computes the same)
template <int BR>
__host__ __device__ constexpr size_t bf16_smem_bytes(int H) {
  return (size_t)2 * bf16_row(H) * (TileBf16<BR>::NC + BR) +
         (size_t)4 * BR * TileBf16<BR>::NC;
}

// The arguments of `dl4j_lstm_fwd_persistent_bf16`: every tensor
// bfloat16; hbuf [2][Bp][hk] (Bp = gridDim.y BR, hk = bf16_hk(H)) carries
// h between the steps, a batch row's K contiguous, zeros past H;
// counters [gridDim.y] start at 0.
struct ArgsBf16 {
  const __nv_bfloat16 *xw, *rw, *p, *h0, *c0, *mask;
  __nv_bfloat16 *hs, *cs, *gates, *hT, *cT, *hbuf;
  unsigned* counters;
  int T, B, H;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A (16 x 16, row-major fragments a) x B (16 x 8, column-major
// fragments b0 b1), bfloat16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (s, r): hidden columns j0 = s HC .., batch rows b0 = r BR ..
template <int BR, bool RESID>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_persistent_bf16_kernel(const ArgsBf16 a) {
  using BF = __nv_bfloat16;
  using G = TileBf16<BR>;
  using E = Elt<BF>;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * H;
  const int HK = bf16_hk(H), RS = bf16_row(H), ksteps = HK / 16;
  extern __shared__ float4 smem4[];
  BF* ws = reinterpret_cast<BF*>(smem4);            // [NC][RS]
  BF* hsm = ws + (size_t)G::NC * RS;                // [BR][RS]
  float* zs = reinterpret_cast<float*>(hsm + (size_t)BR * RS);  // [BR][NC]
  const int j0 = blockIdx.x * G::HC, b0 = blockIdx.y * BR;
  const int Bp = gridDim.y * BR;
  unsigned* counter = a.counters + blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the product: warp w's tile, gate columns mc .. + 15, batch rows nb ..
  // + 7
  const int mc = 16 * (warp % G::MT), nb = 8 * (warp / G::MT);
  // the cell: thread (row, jj) owns batch row b and hidden column j
  const int row = threadIdx.x / G::HC, jj = threadIdx.x % G::HC;
  const int b = b0 + row, j = j0 + jj;
  const bool col_ok = j < H, row_ok = b < B;

  // the strip, resident for the whole sequence (RW's columns read in
  // order, a gate at a time); zeros past H in K and in the columns. Where
  // H and HC are multiples of 8: 16-byte loads of 8 columns of one gate
  // in rows k and k + 1, stored as the pairs (k, k + 1) of their 8
  // transposed rows (2-byte loads took 31 us of a launch at path_l's
  // shape on an H100: tools/torch_b2_bf16_phases.py)
  if (H % 8 == 0 && G::HC % 8 == 0) {
    constexpr int CH = G::NC / 8;
    for (int idx = threadIdx.x; idx < HK / 2 * CH; idx += kThreads) {
      const int k = 2 * (idx / CH), c = 8 * (idx % CH);
      const int g = c / G::HC, jc = c % G::HC, cj = j0 + jc;
      uint4 r0 = make_uint4(0u, 0u, 0u, 0u), r1 = r0;
      if (k < H && cj < H) {
        const BF* src = a.rw + (size_t)k * H4 + g * H + cj;
        r0 = __ldg(reinterpret_cast<const uint4*>(src));
        r1 = __ldg(reinterpret_cast<const uint4*>(src + H4));
      }
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w};
      const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // column jc + e: the low (even e) or high half of word e / 2
        const uint32_t lo = (w0[e / 2] >> (16 * (e & 1))) & 0xffffu;
        const uint32_t hi = (w1[e / 2] >> (16 * (e & 1))) & 0xffffu;
        *reinterpret_cast<uint32_t*>(ws + (size_t)(4 * (jc + e) + g) * RS +
                                     k) = lo | (hi << 16);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < HK * G::NC; idx += kThreads) {
      const int k = idx / G::NC, c = idx % G::NC;
      const int g = c / G::HC, jc = c % G::HC, cj = j0 + jc;
      ws[(size_t)(4 * jc + g) * RS + k] =
          (k < H && cj < H) ? a.rw[(size_t)k * H4 + g * H + cj]
                            : __float2bfloat16_rn(0.f);
    }
  }
  float c_reg = 0.f, h_reg = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (col_ok && row_ok) {
    c_reg = ldf(a.c0, (size_t)b * H + j);
    h_reg = ldf(a.h0, (size_t)b * H + j);
  }
  if (col_ok) {
    p0 = ldf(a.p, j);
    p1 = ldf(a.p, H + j);
    p2 = ldf(a.p, 2 * H + j);
    a.hbuf[(size_t)b * HK + j] = E::st(h_reg);   // rows past B carry zeros
  }
  unsigned target = 0;
  tile_barrier(counter, target);         // h0 is complete in hbuf[0]

  // `ldmatrix` rows: A's lane i gives row (i % 8) + 8 ((i / 8) % 2), K
  // 8 (i / 16) of the k16 step (its four 8 x 8 matrices are the fragments
  // a0-a3); B's gives batch row i % 8, K 8 (i / 8), so one x4 load holds
  // two k16 steps' b0 b1
  const uint32_t a_addr = hopper::smem_u32(
      ws + (size_t)(mc + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
      8 * (lane >> 4));
  const uint32_t b_addr =
      hopper::smem_u32(hsm + (size_t)(nb + (lane & 7)) * RS + 8 * (lane >> 3));
  const int chunks = HK / 8;             // 16-byte copies a row of h

  for (int t = 0; t < T; ++t) {
    // this step's inputs for the cell, in flight during the product
    float xv[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.f;
    if (col_ok && row_ok) {
      const BF* x = a.xw + ((size_t)t * B + b) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[g] = E::ld(x[g * H]);
      m = ldf(a.mask, (size_t)t * B + b);
    }
    // h_{t-1}'s tile: hsm[i][k] = hbuf[t & 1][b0 + i][k]
    const BF* hin = a.hbuf + ((size_t)(t & 1) * Bp + b0) * HK;
    for (int idx = threadIdx.x; idx < BR * chunks; idx += kThreads) {
      const int r = idx / chunks, q = idx % chunks;
      cp_async16_cg(reinterpret_cast<float*>(hsm + (size_t)r * RS + 8 * q),
                    reinterpret_cast<const float*>(hin + (size_t)r * HK +
                                                   8 * q));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    float d[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[u][e] = 0.f;
    for (int s0 = 0; s0 < ksteps; s0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; u += 2) {
        const int s = s0 + u;
        if (s < ksteps) {          // warp-uniform
          uint32_t bf[4], af[4];
          ldmatrix_x4(bf, b_addr + 32 * s);
          ldmatrix_x4(af, a_addr + 32 * s);
          mma_bf16(d[u], af, bf[0], bf[1]);
          if (s + 1 < ksteps) {
            ldmatrix_x4(af, a_addr + 32 * (s + 1));
            mma_bf16(d[u + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
    // the sum rounded once to bfloat16 (as the Pallas body's product in
    // h's dtype), into zs[batch row][gate column]: a thread holds columns
    // mc + lane / 4 (+ 8) of batch rows nb + 2 (lane % 4) (+ 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = ((d[0][e] + d[1][e]) + d[2][e]) + d[3][e];
      const int cc = mc + lane / 4 + 8 * (e / 2);
      const int rr = nb + 2 * (lane % 4) + (e % 2);
      zs[rr * G::NC + cc] = rnd<BF>(v);
    }
    __syncthreads();
    // the cell, rounding after each operation as design 1 does
    const float4 zv =
        *reinterpret_cast<const float4*>(zs + row * G::NC + 4 * jj);
    const float zi = rnd<BF>(zv.x + xv[0]);
    const float zf = rnd<BF>(zv.y + xv[1]);
    const float zg = rnd<BF>(zv.z + xv[2]);
    const float zo = rnd<BF>(zv.w + xv[3]);
    const float cp = c_reg, hp = h_reg;
    const float ig = sigm_r<BF>(rnd<BF>(zi + rnd<BF>(cp * p0)));
    const float fg = sigm_r<BF>(rnd<BF>(zf + rnd<BF>(cp * p1)));
    const float gg = rnd<BF>(tanhf(zg));
    const float c_new = rnd<BF>(rnd<BF>(fg * cp) + rnd<BF>(ig * gg));
    const float og = sigm_r<BF>(rnd<BF>(zo + rnd<BF>(c_new * p2)));
    const float h_new = rnd<BF>(og * rnd<BF>(tanhf(c_new)));
    const float keep = rnd<BF>(1.0f - m);
    h_reg = rnd<BF>(rnd<BF>(m * h_new) + rnd<BF>(keep * hp));
    c_reg = rnd<BF>(rnd<BF>(m * c_new) + rnd<BF>(keep * cp));
    if (col_ok) {
      if (row_ok) {
        const size_t at = ((size_t)t * B + b) * H + j;
        a.hs[at] = E::st(h_reg);
        if (RESID) {
          a.cs[at] = E::st(c_reg);
          BF* gt = a.gates + ((size_t)t * B + b) * H4 + j;
          gt[0] = E::st(ig);
          gt[H] = E::st(fg);
          gt[2 * H] = E::st(gg);
          gt[3 * H] = E::st(og);
        }
      }
      a.hbuf[((size_t)((t + 1) & 1) * Bp + b) * HK + j] = E::st(h_reg);
    }
    tile_barrier(counter, target);   // h_t is complete in hbuf
  }
  if (col_ok && row_ok) {
    a.hT[(size_t)b * H + j] = E::st(h_reg);
    a.cT[(size_t)b * H + j] = E::st(c_reg);
  }
}

template <int BR, bool RESID>
cudaError_t launch_bf16(ArgsBf16 a, cudaStream_t st) {
  using G = TileBf16<BR>;
  auto kernel = lstm_fwd_persistent_bf16_kernel<BR, RESID>;
  const size_t smem = bf16_smem_bytes<BR>(a.H);
  if (smem > (size_t)kSmemFloats * sizeof(float)) return cudaErrorInvalidValue;
  static bool raised = false;
  cudaError_t e = raise_smem_limit(kernel, &raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.H + G::HC - 1) / G::HC, (a.B + BR - 1) / BR);
  // as the float32 design's: the launch fails where the grid cannot be
  // resident at once
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                     dim3(kThreads), args, smem, st);
}

// ----------------------------------------------------- backward, design 2
// The same grid as the forward's: block (s, r) owns HC = 256 / BR hidden
// columns and BR batch rows, a thread the cell of one (row, column), and
// the block's strip of RW (the four gate columns of its HC columns) stays
// in shared memory for all T steps, transposed: wsT[g HC + jc][k] =
// RW[k][g H + j0 + jc]. A step, in reverse time:
//   1. the cell: the thread forms the four gate gradients of its (row,
//      column) from dh and dc (registers) and the residuals, writes dxw[t]
//      and puts them in dgT[c][row] (c = g HC + jc);
//   2. the product: the block's partial dh_prev[b, k] = sum over its NC =
//      4 HC gate columns c of dgT[c][b] wsT[c][k], for its BR rows and all
//      H values of k (a thread 8 rows x 4 k: 32 FFMA from three 16-byte
//      shared loads a c), into a global buffer double-buffered by t & 1;
//      where the block's BR / 8 x H / 4 thread tiles are fewer than its
//      threads, Q thread groups take Q slices of c and their sums are added
//      in group order through shared memory;
//   3. the exchange: after one tile barrier the thread loads the H / HC
//      blocks' partials of its (row, column) through L2 only, up to 32 in
//      flight at once, and sums them in block order, then adds the mask's
//      pass-through (1 - m) dh_in.
// A step moves BR x H floats each way a block, as the forward's h tile,
// and needs no transposed copy of RW. dP: each thread sums its three
// peephole terms over T in registers, the block adds its rows in order
// into dp_part [batch tile][3][H], and lstm_dp_reduce_kernel adds the
// tiles in order. No atomics on data: two launches are bit-equal.

// the product's thread tiles (8 rows x 4 k each) of a block
template <int BR>
__host__ __device__ constexpr int bwd_tiles(int H) {
  return BR / 8 * ((H + 3) / 4);
}

// Q: the thread groups that split the product's gate columns, so that
// the tiles keep all threads busy (at most one group a warp)
__host__ __device__ inline int bwd_ksplit(int tiles) {
  int q = 1;
  while (q < kWarps && 2 * q * tiles <= kThreads) q *= 2;
  return q;
}

// floats of shared memory: the strip [NC][Hp + 4] (Hp = H rounded up to 4;
// the pad spreads the staging writes over the banks), dgT [NC][BR] and,
// where Q > 1, the groups' sums [Q][BR][Hp]
template <int BR>
__host__ __device__ size_t bwd_smem_floats(int H) {
  constexpr int NC = 1024 / BR;
  const int Hp = (H + 3) / 4 * 4;
  const int Q = bwd_ksplit(bwd_tiles<BR>(H));
  return (size_t)NC * (Hp + 4) + NC * BR + (Q > 1 ? (size_t)Q * BR * Hp : 0);
}

// The arguments of `dl4j_lstm_bwd_persistent` (E float) and
// `dl4j_lstm_bwd_persistent_bf16` (E bfloat16): part [2][S][Bp][Hp] (S =
// gridDim.x, Bp = gridDim.y BR; bfloat16: Hp = bf16_hk(H)) float32 carries
// the partial dh_prev of each block between the product and the exchange;
// counters [gridDim.y] start at 0.
template <typename E>
struct BwdArgsT {
  const E *dhs, *gates, *cs, *rw, *p, *mask, *dhT, *dcT, *c0;
  E *dxw, *dh0, *dc0;
  float *dp_part, *part;
  unsigned* counters;
  int T, B, H;
};
using BwdArgs = BwdArgsT<float>;

template <typename E>
__device__ __forceinline__ Resid load_resid(const BwdArgsT<E>& a, int t,
                                            int b, int j, bool ok) {
  Resid r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (ok) {
    const int B = a.B, H = a.H;
    const size_t at = ((size_t)t * B + b) * H + j;
    const E* gt = a.gates + ((size_t)t * B + b) * 4 * H + j;
    r.i = Elt<E>::ld(__ldg(gt));
    r.f = Elt<E>::ld(__ldg(gt + H));
    r.g = Elt<E>::ld(__ldg(gt + 2 * H));
    r.o = Elt<E>::ld(__ldg(gt + 3 * H));
    r.c = Elt<E>::ld(__ldg(a.cs + at));
    r.cp = Elt<E>::ld(t == 0 ? __ldg(a.c0 + (size_t)b * H + j)
                             : __ldg(a.cs + at - (size_t)B * H));
    r.dho = Elt<E>::ld(__ldg(a.dhs + at));
    r.m = Elt<E>::ld(__ldg(a.mask + (size_t)t * B + b));
  }
  return r;
}

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// Block (s, r): hidden columns j0 = s HC .., batch rows b0 = r BR ..
template <int BR>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_persistent_kernel(const BwdArgs a) {
  constexpr int NC = 1024 / BR, HC = 256 / BR;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * H;
  const int Hp = (H + 3) / 4 * 4, HS = Hp + 4, KQ = Hp / 4;
  const int tiles = bwd_tiles<BR>(H), Q = bwd_ksplit(tiles);
  extern __shared__ float4 smem4[];
  float* wsT = reinterpret_cast<float*>(smem4);   // [NC][HS]
  float* dgT = wsT + (size_t)NC * HS;             // [NC][BR]
  float* red = dgT + NC * BR;                     // [Q][BR][Hp]
  const int S = gridDim.x, Bp = gridDim.y * BR;
  const int j0 = blockIdx.x * HC, b0 = blockIdx.y * BR;
  unsigned* counter = a.counters + blockIdx.y;
  // the cell: thread (row, jj) owns batch row b and hidden column j
  const int row = threadIdx.x / HC, jj = threadIdx.x % HC;
  const int b = b0 + row, j = j0 + jj;
  const bool col_ok = j < H, ok = col_ok && b < B;
  // the product: group q sums gate columns [c_lo, c_hi) for tiles u,
  // u + per, ..; tile i holds rows 8 (i / KQ) .. + 7, k 4 (i % KQ) .. + 3
  const int per = kThreads / Q;
  const int q = threadIdx.x / per, u = threadIdx.x % per;
  const int c_lo = q * (NC / Q), c_hi = c_lo + NC / Q;

  // the strip, resident for the whole sequence; zeros past H
  for (int idx = threadIdx.x; idx < NC * Hp; idx += kThreads) {
    const int c = idx % NC, k = idx / NC;
    const int cj = j0 + c % HC;
    wsT[(size_t)c * HS + k] =
        (cj < H && k < H) ? a.rw[(size_t)k * H4 + (c / HC) * H + cj] : 0.f;
  }
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, dh = 0.f, dc = 0.f;
  if (col_ok) {
    p0 = a.p[j];
    p1 = a.p[H + j];
    p2 = a.p[2 * H + j];
  }
  if (ok) {
    dh = a.dhT[(size_t)b * H + j];
    dc = a.dcT[(size_t)b * H + j];
  }
  float dpa[3] = {0.f, 0.f, 0.f};
  Resid cur = load_resid(a, T - 1, b, j, ok);
  unsigned target = 0;

  for (int t = T - 1; t >= 0; --t) {
    // 1. the cell
    const float dh_in = cur.dho + dh;
    const float dh_t = cur.m * dh_in;
    const float pass_h = (1.0f - cur.m) * dh_in;
    const float tanh_c = tanhf(cur.c);
    const float do_pre = dh_t * tanh_c * cur.o * (1.0f - cur.o);
    const float dc_new = cur.m * dc
        + dh_t * cur.o * (1.0f - tanh_c * tanh_c) + do_pre * p2;
    const float di_pre = dc_new * cur.g * cur.i * (1.0f - cur.i);
    const float df_pre = dc_new * cur.cp * cur.f * (1.0f - cur.f);
    const float dg_pre = dc_new * cur.i * (1.0f - cur.g * cur.g);
    dc = dc_new * cur.f + (1.0f - cur.m) * dc + di_pre * p0 + df_pre * p1;
    dpa[0] += di_pre * cur.cp;
    dpa[1] += df_pre * cur.cp;
    dpa[2] += do_pre * cur.c;
    if (ok) {
      float* dx = a.dxw + ((size_t)t * B + b) * H4 + j;
      dx[0] = di_pre;
      dx[H] = df_pre;
      dx[2 * H] = dg_pre;
      dx[3 * H] = do_pre;
    }
    dgT[(0 * HC + jj) * BR + row] = di_pre;
    dgT[(1 * HC + jj) * BR + row] = df_pre;
    dgT[(2 * HC + jj) * BR + row] = dg_pre;
    dgT[(3 * HC + jj) * BR + row] = do_pre;
    // the next step's residuals, in flight during the product and the wait
    if (t > 0) cur = load_resid(a, t - 1, b, j, ok);
    __syncthreads();     // dgT is complete (and at t = T - 1, the strip)

    // 2. the product
    float* out = a.part + ((size_t)((t & 1) * S + blockIdx.x) * Bp + b0) * Hp;
    for (int i = u; i < tiles; i += per) {
      const int kq = i % KQ, rg = i / KQ;
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[r][kk] = 0.f;
#pragma unroll 16
      for (int c = c_lo; c < c_hi; ++c) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(wsT + (size_t)c * HS + 4 * kq);
        const float4 da =
            *reinterpret_cast<const float4*>(dgT + c * BR + 8 * rg);
        const float4 db =
            *reinterpret_cast<const float4*>(dgT + c * BR + 8 * rg + 4);
        const float dv[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            acc[r][kk] = fmaf(dv[r], wv[kk], acc[r][kk]);
      }
      float* dst = Q == 1 ? out : red + (size_t)q * BR * Hp;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        *reinterpret_cast<float4*>(dst + (size_t)(8 * rg + r) * Hp + 4 * kq) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    if (Q > 1) {        // the groups' sums, added in group order
      __syncthreads();
      for (int o = threadIdx.x; o < BR * KQ; o += kThreads) {
        const size_t at = (size_t)(o / KQ) * Hp + 4 * (o % KQ);
        float4 s = *reinterpret_cast<const float4*>(red + at);
        for (int qq = 1; qq < Q; ++qq)
          add4(s, *reinterpret_cast<const float4*>(
                      red + (size_t)qq * BR * Hp + at));
        *reinterpret_cast<float4*>(out + at) = s;
      }
    }
    tile_barrier(counter, target);   // every block's partial is written

    // 3. the exchange: the blocks' partials in block order, through L2
    if (col_ok) {
      const float* in = a.part + ((size_t)(t & 1) * S * Bp + b) * Hp + j;
      const size_t step = (size_t)Bp * Hp;
      float v[32];       // up to 32 blocks' partials in flight at once
#pragma unroll
      for (int sb = 0; sb < 32; ++sb)
        v[sb] = sb < S ? __ldcg(in + sb * step) : 0.f;
      float s = 0.f;
#pragma unroll
      for (int sb = 0; sb < 32; ++sb)
        if (sb < S) s += v[sb];
      for (int sb = 32; sb < S; ++sb) s += __ldcg(in + sb * step);
      dh = s + pass_h;
    }
  }

  if (ok) {
    a.dh0[(size_t)b * H + j] = dh;
    a.dc0[(size_t)b * H + j] = dc;
  }
  // dP: the block's rows added in row order (dgT is free after the last
  // barrier)
  float* sdp = dgT;                       // [3][BR][HC]
#pragma unroll
  for (int qq = 0; qq < 3; ++qq) sdp[(qq * BR + row) * HC + jj] = dpa[qq];
  __syncthreads();
  if (threadIdx.x < 3 * HC) {
    const int qq = threadIdx.x / HC, jc = threadIdx.x % HC;
    if (j0 + jc < H) {
      float s = 0.f;
      for (int r = 0; r < BR; ++r) s += sdp[(qq * BR + r) * HC + jc];
      a.dp_part[((size_t)blockIdx.y * 3 + qq) * H + j0 + jc] = s;
    }
  }
}

template <int BR>
cudaError_t launch_bwd(BwdArgs a, cudaStream_t st) {
  constexpr int HC = 256 / BR;
  auto kernel = lstm_bwd_persistent_kernel<BR>;
  const size_t smem = sizeof(float) * bwd_smem_floats<BR>(a.H);
  if (smem > (size_t)kSmemFloats * sizeof(float)) return cudaErrorInvalidValue;
  static bool raised = false;
  cudaError_t e = raise_smem_limit(kernel, &raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.H + HC - 1) / HC, (a.B + BR - 1) / BR);
  // as the forward's: the launch fails where the grid cannot be resident
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                     dim3(kThreads), args, smem, st);
}

// ------------------------------------------ backward, design 2, bfloat16
// The float32 design 2's grid, exchange and barrier in bfloat16, with the
// step's product on the tensor cores as in the bfloat16 forward. Design 1
// (`lstm_bwd_kernel<__nv_bfloat16>`) streamed a float32 copy of RW^T from
// L2 every step, in 8-block clusters of 8 batch rows (64 blocks at
// path_l's shape), with FFMA on 2-byte loads and two cluster barriers a
// step. Block (s, r) owns HC = 256 / BR hidden columns and BR batch rows;
// its strip of RW, the NC = 4 HC gate columns c = g HC + jc (RW's column
// g H + j0 + jc) over all H rows, is staged once in bfloat16 as RW lies:
// ws[k][c], the row-major A operand of `mma.sync` m16n8k16 with k as M
// and the gate columns as K, so no transposed or widened copy of RW is
// made. At H 512 BR 8 fits (141 KB), 8 batch tiles x 16 column blocks =
// 128 blocks. A step, in reverse time:
//   1. the cell (`cell_bwd`, design 1's rounding): dxw[t], and the gate
//      gradients, exact in bfloat16, into dgs[row][c], the column-major B
//      operand (batch rows as N);
//   2. the product: the block's partial dh_prev[b, k] = sum over its NC
//      columns c of dgs[b][c] ws[k][c], for its BR rows and every k: HK /
//      16 x BR / 8 tiles of 16 x 8 (HK = H rounded up to 16), each a chain
//      of NC / 16 `mma.sync`; warp w takes tiles w, w + 8, .. four at a
//      time (independent chains) and stores its float32 sums into part
//      [2][S][Bp][HK], double-buffered by t & 1;
//   3. the exchange, after one tile barrier: a thread adds the S blocks'
//      partials of its (row, column) in block order through L2, rounds the
//      sum to bfloat16 (where the Pallas body's product is emitted in dh's
//      dtype), adds the mask's pass-through and rounds again.
// A staged row is NC + 8 elements, so the 8 rows an `ldmatrix` reads lie
// in 8 different bank groups. The strip's copy (16-byte cp.async where H
// and HC are multiples of 8) is in flight during the first step's cell.
// dP as float32's: float32 sums a thread, the block's rows in order into
// dp_part. No atomics on data: two launches are bit-equal.
template <int BR>
struct BwdTileBf16 {
  static constexpr int NC = 1024 / BR;   // gate columns
  static constexpr int HC = NC / 4;      // hidden columns
  static constexpr int RS = NC + 8;      // a staged row (elements)
  static constexpr int NT = BR / 8;      // the product's 8-row batch tiles
  static constexpr int KS = NC / 16;     // its k16 steps
};

// bytes of shared memory: the strip [HK][RS] and dgs [BR][RS] in bfloat16
// (ops/lstm.py `b2c_rows` with esize 2 computes the same); dP's block sum
// [3][BR][HC] float32, 3 KB, reuses them after the last step (they are at
// least 3840 bytes)
template <int BR>
__host__ __device__ constexpr size_t bwd_bf16_smem_bytes(int H) {
  return (size_t)2 * BwdTileBf16<BR>::RS * (bf16_hk(H) + BR);
}

using BwdArgsBf16 = BwdArgsT<__nv_bfloat16>;

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// Block (s, r): hidden columns j0 = s HC .., batch rows b0 = r BR ..
template <int BR>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_persistent_bf16_kernel(const BwdArgsBf16 a) {
  using BF = __nv_bfloat16;
  using G = BwdTileBf16<BR>;
  using E = Elt<BF>;
  constexpr int NC = G::NC, HC = G::HC, RS = G::RS;
  const int T = a.T, B = a.B, H = a.H, H4 = 4 * H;
  const int HK = bf16_hk(H), MT = HK / 16, tiles = MT * G::NT;
  extern __shared__ float4 smem4[];
  BF* ws = reinterpret_cast<BF*>(smem4);          // [HK][RS]
  BF* dgs = ws + (size_t)HK * RS;                 // [BR][RS]
  const int S = gridDim.x, Bp = gridDim.y * BR;
  const int j0 = blockIdx.x * HC, b0 = blockIdx.y * BR;
  unsigned* counter = a.counters + blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the cell: thread (row, jj) owns batch row b and hidden column j
  const int row = threadIdx.x / HC, jj = threadIdx.x % HC;
  const int b = b0 + row, j = j0 + jj;
  const bool col_ok = j < H, ok = col_ok && b < B;

  // the strip, resident for the whole sequence: ws[k][g HC + jc] =
  // RW[k][g H + j0 + jc], zeros past H
  if (H % 8 == 0 && HC % 8 == 0) {     // 16-byte chunks of one gate
    constexpr int CH = NC / 8;
    for (int idx = threadIdx.x; idx < HK * CH; idx += kThreads) {
      const int k = idx / CH, c = 8 * (idx % CH);
      const int cj = j0 + c % HC;
      BF* dst = ws + (size_t)k * RS + c;
      if (k < H && cj < H)
        cp_async16_cg(reinterpret_cast<float*>(dst),
                      reinterpret_cast<const float*>(
                          a.rw + (size_t)k * H4 + (c / HC) * H + cj));
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int idx = threadIdx.x; idx < HK * NC; idx += kThreads) {
      const int k = idx / NC, c = idx % NC;
      const int cj = j0 + c % HC;
      ws[(size_t)k * RS + c] = (k < H && cj < H)
          ? a.rw[(size_t)k * H4 + (c / HC) * H + cj]
          : __float2bfloat16_rn(0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, dh = 0.f, dc = 0.f;
  if (col_ok) {
    p0 = ldf(a.p, j);
    p1 = ldf(a.p, H + j);
    p2 = ldf(a.p, 2 * H + j);
  }
  if (ok) {
    dh = ldf(a.dhT, (size_t)b * H + j);
    dc = ldf(a.dcT, (size_t)b * H + j);
  }
  float dpa[3] = {0.f, 0.f, 0.f};
  Resid cur = load_resid(a, T - 1, b, j, ok);
  unsigned target = 0;
  // `ldmatrix` rows: A's lane i gives strip row (i % 8) + 8 ((i / 8) % 2)
  // of its M tile, columns 8 (i / 16) of the k16 step (fragments a0-a3);
  // B's (x2, lanes 0-15) batch row i % 8 of its N tile, columns 8 ((i / 8)
  // % 2) (b0, b1)
  const uint32_t a_lane = hopper::smem_u32(
      ws + (size_t)((lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
      8 * (lane >> 4));
  const uint32_t b_lane = hopper::smem_u32(
      dgs + (size_t)(lane & 7) * RS + 8 * ((lane >> 3) & 1));

  for (int t = T - 1; t >= 0; --t) {
    // 1. the cell
    float dg[4];
    const float pass_h = cell_bwd<BF>(cur, dh, dc, p0, p1, p2, dg, dpa);
    if (ok) {
      BF* dx = a.dxw + ((size_t)t * B + b) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) dx[g * H] = E::st(dg[g]);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) dgs[row * RS + g * HC + jj] = E::st(dg[g]);
    // the next step's residuals, in flight during the product and the wait
    if (t > 0) cur = load_resid(a, t - 1, b, j, ok);
    if (t == T - 1) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();     // dgs is complete (and at t = T - 1, the strip)

    // 2. the product, four tiles a warp at a time
    float* out = a.part + ((size_t)((t & 1) * S + blockIdx.x) * Bp + b0) * HK;
    for (int i0 = warp; i0 < tiles; i0 += 4 * kWarps) {
      float d[4][4];
      uint32_t aa[4], ba[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = min(i0 + u * kWarps, tiles - 1);
        aa[u] = a_lane + 2 * 16 * RS * (i % MT);
        ba[u] = b_lane + 2 * 8 * RS * (i / MT);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[u][e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < G::KS; ++s) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i0 + u * kWarps < tiles) {     // warp-uniform
            uint32_t af[4], bfr[2];
            ldmatrix_x2(bfr, ba[u] + 32 * s);
            ldmatrix_x4(af, aa[u] + 32 * s);
            mma_bf16(d[u], af, bfr[0], bfr[1]);
          }
        }
      }
      // a lane holds k 16 mt + lane / 4 (+ 8) of batch rows 8 nt + 2 (lane
      // % 4) (+ 1)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kWarps;
        if (i < tiles) {
          float* o = out + (size_t)(8 * (i / MT) + 2 * (lane % 4)) * HK +
                     16 * (i % MT) + lane / 4;
          o[0] = d[u][0];
          o[HK] = d[u][1];
          o[8] = d[u][2];
          o[HK + 8] = d[u][3];
        }
      }
    }
    tile_barrier(counter, target);   // every block's bf16 partial is out

    // 3. the exchange: the blocks' partials in block order, through L2
    if (col_ok) {
      const float* in = a.part + ((size_t)(t & 1) * S * Bp + b) * HK + j;
      const size_t step = (size_t)Bp * HK;
      float v[32];       // up to 32 blocks' partials in flight at once
#pragma unroll
      for (int sb = 0; sb < 32; ++sb)
        v[sb] = sb < S ? __ldcg(in + sb * step) : 0.f;
      float s = 0.f;
#pragma unroll
      for (int sb = 0; sb < 32; ++sb)
        if (sb < S) s += v[sb];
      for (int sb = 32; sb < S; ++sb) s += __ldcg(in + sb * step);
      dh = rnd<BF>(rnd<BF>(s) + pass_h);
    }
  }

  if (ok) {
    a.dh0[(size_t)b * H + j] = E::st(dh);
    a.dc0[(size_t)b * H + j] = E::st(dc);
  }
  // dP: the block's rows added in row order, over the strip (free after
  // the last barrier)
  float* sdp = reinterpret_cast<float*>(smem4);   // [3][BR][HC]
#pragma unroll
  for (int q = 0; q < 3; ++q) sdp[(q * BR + row) * HC + jj] = dpa[q];
  __syncthreads();
  if (threadIdx.x < 3 * HC) {
    const int q = threadIdx.x / HC, jc = threadIdx.x % HC;
    if (j0 + jc < H) {
      float s = 0.f;
      for (int r = 0; r < BR; ++r) s += sdp[(q * BR + r) * HC + jc];
      a.dp_part[((size_t)blockIdx.y * 3 + q) * H + j0 + jc] = s;
    }
  }
}

template <int BR>
cudaError_t launch_bwd_bf16(BwdArgsBf16 a, cudaStream_t st) {
  constexpr int HC = BwdTileBf16<BR>::HC;
  auto kernel = lstm_bwd_persistent_bf16_kernel<BR>;
  const size_t smem = bwd_bf16_smem_bytes<BR>(a.H);
  if (smem > (size_t)kSmemFloats * sizeof(float)) return cudaErrorInvalidValue;
  static bool raised = false;
  cudaError_t e = raise_smem_limit(kernel, &raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.H + HC - 1) / HC, (a.B + BR - 1) / BR);
  // as the float32 design's: the launch fails where the grid cannot be
  // resident at once
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                     dim3(kThreads), args, smem, st);
}

}  // namespace persist

// ------------------------------------------- weight gradients, design 2
// dRW [H, 4H] = hprev^T dxw over K = T·B rows (hprev = [h0; hs[:-1]]), a
// float32 SGEMM whose operands are both K-major: a row of either is
// contiguous along M (H) or N (4H). A block owns a 128x128 tile of dRW
// and one of `splits` slices of K; 256 threads, each an 8x8 tile of
// outputs (rows 4 ty .. + 3 and 64 + 4 ty .., columns likewise with tx),
// fed by four 16-byte shared loads a row of K. The operands go straight
// from global to shared memory with cp.async (16 bytes a thread; 4 where
// H is not a multiple of 4), through a ring of kStages stages of 16 rows
// of K, one barrier a stage. Two blocks an SM (64 KB of ring, at most 128
// registers a thread). Where K is split, each block writes its partial
// tile, and the last block of a tile to arrive (a counter, after a fence)
// adds the partials in slice order: no atomics on data, two launches are
// bit-equal.
namespace pipe {

constexpr int BM = 128, BN = 128, BK = 16, kStages = 4;
// a thread's rows: MI groups of 4, BM / MI apart; its columns: two groups
// of 4, 64 apart
constexpr int MI = 2;
constexpr int kThreads = 16 * BM / (4 * MI);
constexpr int kSmemBytes = kStages * BK * (BM + BN) * (int)sizeof(float);

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// counters [tiles] start at 0; part [splits][H][4H] when splits > 1
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
lstm_drw_pipelined_kernel(const float* __restrict__ hs,
                          const float* __restrict__ h0,
                          const float* __restrict__ dxw,
                          float* __restrict__ drw, float* __restrict__ part,
                          unsigned* __restrict__ counters, int T, int B,
                          int H, int splits, long long kchunk) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);     // [kStages][BK][BM]
  float* b_s = a_s + kStages * BK * BM;             // [kStages][BK][BN]
  __shared__ int last;
  const int M = H, N = 4 * H;
  const long long K = (long long)T * B;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const long long kbeg = blockIdx.z * kchunk;
  const long long kend = kbeg + kchunk < K ? kbeg + kchunk : K;
  const int nk = kend > kbeg ? (int)((kend - kbeg + BK - 1) / BK) : 0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  constexpr int RM = 4 * MI;          // rows a thread
  auto mrow = [&](int i) { return m0 + (i / 4) * (BM / MI) + 4 * ty + i % 4; };

  // stage kt's rows of K into ring slot `slot`; zeros past the slice,
  // past M and past N
  auto load = [&](int kt, int slot) {
    const long long kb = kbeg + (long long)kt * BK;
    float* as = a_s + slot * BK * BM;
    float* bs = b_s + slot * BK * BN;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < BK * BM / 4 / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / (BM / 4), m = m0 + 4 * (idx % (BM / 4));
        const long long k = kb + r;
        const bool ok = k < kend && m < M;
        const float* src = !ok ? h0
            : k < B ? h0 + k * H + m : hs + (k - B) * H + m;
        cp_async16(as + r * BM + 4 * (idx % (BM / 4)), src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * BM / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / BM, m = m0 + idx % BM;
        const long long k = kb + r;
        const bool ok = k < kend && m < M;
        const float* src = !ok ? h0
            : k < B ? h0 + k * H + m : hs + (k - B) * H + m;
        cp_async4(as + r * BM + idx % BM, src, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (BN / 4), n = n0 + 4 * (idx % (BN / 4));
      const long long k = kb + r;
      const bool ok = k < kend && n < N;
      cp_async16(bs + r * BN + 4 * (idx % (BN / 4)),
                 ok ? dxw + k * N + n : dxw, ok);
    }
  };

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) acc[i][jn] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();     // stage kt has landed; stage kt - 1 is consumed
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt, nxt % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* as = a_s + (kt % kStages) * BK * BM;
    const float* bs = b_s + (kt % kStages) * BK * BN;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      float av[RM];
#pragma unroll
      for (int g = 0; g < MI; ++g) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            as + r * BM + g * (BM / MI) + 4 * ty);
        av[4 * g] = a4.x;
        av[4 * g + 1] = a4.y;
        av[4 * g + 2] = a4.z;
        av[4 * g + 3] = a4.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(bs + r * BN + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + r * BN + 64 + 4 * tx);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          acc[i][jn] = fmaf(av[i], bv[jn], acc[i][jn]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // the thread's outputs: rows mrow(i), the two float4 columns n0 + 4 tx
  // and n0 + 64 + 4 tx
  float* dst = splits == 1 ? drw : part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = mrow(i);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      if (n < N)
        *reinterpret_cast<float4*>(dst + (size_t)m * N + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
  if (splits == 1) return;
  __threadfence();       // this block's partial, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(counters + tile, 1u) == (unsigned)splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();       // every partial of the tile is visible
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = mrow(i);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      if (n >= N) continue;
      const size_t at = (size_t)m * N + n;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < splits; ++sp)
        persist::add4(s, __ldcg(reinterpret_cast<const float4*>(
                             part + (size_t)sp * M * N + at)));
      *reinterpret_cast<float4*>(drw + at) = s;
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* hs, const float* h0, const float* dxw,
                   float* drw, float* part, unsigned* counters, int T, int B,
                   int H, int splits, cudaStream_t st) {
  auto kernel = lstm_drw_pipelined_kernel<VEC>;
  static bool raised = false;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const long long K = (long long)T * B;
  const long long kchunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((4 * H + BN - 1) / BN, (H + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, kSmemBytes, st>>>(hs, h0, dxw, drw, part,
                                             counters, T, B, H, splits,
                                             kchunk);
  return cudaGetLastError();
}

}  // namespace pipe

// ---------------------------------- weight gradients, design 2, bfloat16
// dRW [H, 4H] = hprev^T dxw over K = T·B rows, bfloat16 operands on the
// tensor cores (see the top of this file). Both operands lie with K
// outermost, so both are read through the transpose bits: A (hprev, M =
// H) M-major, B (dxw, N = 4H) N-major. A block owns a 128 x 256 tile of
// dRW (two consumer warpgroups of m64n256k16, 64 rows each) and one slice
// of the K tiles; a producer warp keeps TMA loads of 64-deep K tiles (A:
// two [64][64] boxes, B: four) in flight through a 4-stage ring of
// full/empty mbarriers. hprev straddles two tensors, so the K tiles come
// in two runs: ceil(B / 64) tiles of h0 (rows past B zero-filled by TMA,
// against dxw's first rows), then ceil((T - 1) B / 64) tiles of hs
// against dxw from row B on (rows past T·B zero-filled), which takes any
// B. The S slices of a tile are one cluster (S <= 8): each block stages
// its float32 sums in its own shared memory (the ring, idle by then), and
// after a cluster barrier block r adds rows [r 128 / S, (r + 1) 128 / S)
// of the S tiles through distributed shared memory in slice order and
// writes them rounded once to bfloat16. No float32 partials leave the
// SMs (at path_l's 4 slices they would be 16 MB, which with the 40 MB of
// operands overflows L2, and their stores and reads took longer than the
// products), no atomics, and two launches are bit-equal. TMA needs
// 16-byte rows, so H is a multiple of 8.
namespace wg {

using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64, kStages = 4;
constexpr int kThreads = 384;     // warpgroups 0, 1 compute; 2 loads
constexpr int kBox = 64 * BK * 2;             // one [BK][64] box: 8 KB
constexpr int kStageBytes = (BM / 64 + BN / 64) * kBox;   // 48 KB
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kMaxSplits = 8;                 // a portable cluster
constexpr int kRowF = BN + 8;     // a staged row of sums (floats; the pad
                                  // spreads a warp's 8 rows over the banks)
static_assert(BM * kRowF * 4 <= kStages * kStageBytes, "sums fit the ring");

// n0: the K tiles of h0; nk: all K tiles; per: the K tiles a slice; the
// slices of a tile (gridDim.z) are one cluster
__global__ void __launch_bounds__(kThreads, 1)
lstm_drw_wgmma_kernel(const __grid_constant__ CUtensorMap h0map,
                      const __grid_constant__ CUtensorMap hsmap,
                      const __grid_constant__ CUtensorMap dmap,
                      __nv_bfloat16* __restrict__ drw, int B, int H, int n0,
                      int nk, int per) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float* sums = reinterpret_cast<float*>(ring);   // [BM][kRowF], at the end
  cg::cluster_group cluster = cg::this_cluster();
  const int M = H, N = 4 * H;
  const int nt0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int kt0 = rank * per;
  const int kt1 = min(nk, kt0 + per);
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);    // one arrival from each warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (t == 0) {
      for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
        const int s = it % kStages, round = it / kStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* st = ring + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        const bool first = kt < n0;
        const CUtensorMap* amap = first ? &h0map : &hsmap;
        const int arow = (first ? kt : kt - n0) * BK;
        const int drow = first ? kt * BK : B + (kt - n0) * BK;
#pragma unroll
        for (int i = 0; i < BM / 64; ++i)
          tma_load_2d(st + i * kBox, amap, &full[s], m0 + 64 * i, arow);
#pragma unroll
        for (int i = 0; i < BN / 64; ++i)
          tma_load_2d(st + (BM / 64 + i) * kBox, &dmap, &full[s],
                      nt0 + 64 * i, drow);
      }
    }
    __syncwarp();
    cluster.sync();      // the slices' sums are staged
    cluster.sync();      // every block is done reading them
    return;
  }

  // ------------------------------------------------------------- consumers
  reg_alloc<232>();
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int prev = 0;
  for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* a = ring + s * kStageBytes + wgi * kBox;
    const uint8_t* b = ring + s * kStageBytes + (BM / 64) * kBox;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaBf16<BN, 1, 1>::run(acc, sw128_desc(a + kk * 2048, kBox, 1024),
                               sw128_desc(b + kk * 2048, kBox, 1024));
    wgmma_commit();
    fence_regs(acc);
    // the previous tile's products are done: its stage goes back
    wgmma_wait<1>();
    fence_regs(acc);
    if (it > 0 && t == 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  bar_sync(1, 256);      // both warpgroups are done with the ring

  // the block's sums into sums[row][col]: a thread holds rows r0 (+ 8),
  // columns 8 j + 2 (lane % 4) (+ 1)
  const int warp = t / 32, lane = t % 32;
  const int r0 = wgi * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(sums + (r0 + 8 * h) * kRowF + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  cluster.sync();

  // block `rank` adds its rows of the tile over the slices in order
  const float* src[kMaxSplits];
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q)
    src[q] = q < splits ? cluster.map_shared_rank(sums, q) : sums;
  const int rlo = rank * BM / splits, rhi = (rank + 1) * BM / splits;
  for (int i = t + 128 * wgi; i < (rhi - rlo) * (BN / 4); i += 256) {
    const int row = rlo + i / (BN / 4), c4 = 4 * (i % (BN / 4));
    const int m = m0 + row, n = nt0 + c4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < splits) {
        const float4 u =
            *reinterpret_cast<const float4*>(src[q] + row * kRowF + c4);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
    }
    if (m < M && n < N) {      // N is a multiple of 32: all four or none
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(drw + (size_t)m * N + n);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
  cluster.sync();
}

// the K tiles of h0 and of all of hprev
__host__ __device__ inline int ktiles_h0(int B) { return (B + BK - 1) / BK; }
__host__ __device__ inline int ktiles(int T, int B) {
  return ktiles_h0(B) + (int)(((long long)(T - 1) * B + BK - 1) / BK);
}

cudaError_t raise_smem() {
  static bool raised = false;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_drw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t config(dim3 grid, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch(const void* hs, const void* h0, const void* dxw,
                   void* drw, int T, int B, int H, int splits,
                   cudaStream_t st) {
  CUtensorMap h0m, hsm, dm;
  const uint32_t box[2] = {64, BK};
  const uint64_t hstride[1] = {(uint64_t)H * 2};
  const uint64_t h0d[2] = {(uint64_t)H, (uint64_t)B};
  const uint64_t hsd[2] = {(uint64_t)H, (uint64_t)T * B};
  const uint64_t dd[2] = {(uint64_t)4 * H, (uint64_t)T * B};
  const uint64_t dstride[1] = {(uint64_t)8 * H};
  int rc = encode_tensor_map(&h0m, h0, 2, h0d, hstride, box);
  if (rc == 0) rc = encode_tensor_map(&hsm, hs, 2, hsd, hstride, box);
  if (rc == 0) rc = encode_tensor_map(&dm, dxw, 2, dd, dstride, box);
  if (rc) return static_cast<cudaError_t>(rc);
  cudaError_t e = raise_smem();
  if (e != cudaSuccess) return e;
  const int nk = ktiles(T, B);
  const int per = (nk + splits - 1) / splits;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(
      dim3((4 * H + BN - 1) / BN, (H + BM - 1) / BM, splits), st, attr);
  e = cudaLaunchKernelEx(
      &cfg, lstm_drw_wgmma_kernel, h0m, hsm, dm,
      static_cast<__nv_bfloat16*>(drw), B, H, ktiles_h0(B), nk, per);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// Design 1's launches by element type (the C functions below pick one).
template <typename E, bool R>
cudaError_t launch_fwd1(const void* xw, const void* rw, const void* p,
                        const void* h0, const void* c0, const void* mask,
                        void* hs, void* cs, void* gates, void* hT, void* cT,
                        int T, int B, int H, cudaStream_t st) {
  const Geom geo = geometry(H, 4);
  const int fixed = 2 * H * kBT;
  const int stages = stages_for(fixed);
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)fixed + stages * kStageFloats);
  const dim3 grid(kCluster, (B + kBT - 1) / kBT);
  // each instantiation raises its own dynamic shared-memory limit, once
  static bool raised = false;
  cudaError_t e = raise_smem_limit(lstm_fwd_kernel<E, R>, &raised);
  if (e != cudaSuccess) return e;
  lstm_fwd_kernel<E, R><<<grid, 4 * geo.Hcp, smem, st>>>(
      static_cast<const E*>(xw), static_cast<const float*>(rw),
      static_cast<const E*>(p), static_cast<const E*>(h0),
      static_cast<const E*>(c0), static_cast<const E*>(mask),
      static_cast<E*>(hs), static_cast<E*>(cs), static_cast<E*>(gates),
      static_cast<E*>(hT), static_cast<E*>(cT), T, B, H, geo, stages);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_bwd1(const void* dhs, const void* gates, const void* cs,
                        const void* rwT, const void* p, const void* mask,
                        const void* dhT, const void* dcT, const void* c0,
                        void* dxw, void* dh0, void* dc0, void* dp_part, int T,
                        int B, int H, cudaStream_t st) {
  const Geom geo = geometry(H, 1);
  const int fixed = 4 * H * kBT + kBT * geo.Hcp;
  const int stages = stages_for(fixed);
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)fixed + stages * kStageFloats);
  const dim3 grid(kCluster, (B + kBT - 1) / kBT);
  static bool raised = false;
  cudaError_t e = raise_smem_limit(lstm_bwd_kernel<E>, &raised);
  if (e != cudaSuccess) return e;
  using C = const E*;
  lstm_bwd_kernel<E><<<grid, 4 * geo.Hcp, smem, st>>>(
      static_cast<C>(dhs), static_cast<C>(gates), static_cast<C>(cs),
      static_cast<const float*>(rwT), static_cast<C>(p),
      static_cast<C>(mask), static_cast<C>(dhT), static_cast<C>(dcT),
      static_cast<C>(c0), static_cast<E*>(dxw), static_cast<E*>(dh0),
      static_cast<E*>(dc0), static_cast<float*>(dp_part), T, B, H, geo,
      stages);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_weights1(const void* hs, const void* h0, const void* dxw,
                            const void* dp_part, void* drw, void* dp, int T,
                            int B, int H, int tiles, cudaStream_t st) {
  const dim3 grid((4 * H + kTileN - 1) / kTileN, (H + kTileM - 1) / kTileM);
  lstm_drw_kernel<E><<<grid, 256, 0, st>>>(
      static_cast<const E*>(hs), static_cast<const E*>(h0),
      static_cast<const E*>(dxw), static_cast<E*>(drw), T, B, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lstm_dp_reduce_kernel<E><<<(3 * H + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dp_part), static_cast<E*>(dp), tiles, H);
  return cudaGetLastError();
}

extern "C" {

// batch rows a cluster: the caller sizes dp_part [ceil(B / tile), 3, H]
int dl4j_lstm_batch_tile() { return kBT; }

// Design 1 of B2a (`residuals`) and B2b. Contiguous, of `dtype` (0
// float32, 1 bfloat16) but rw, which is float32 in both: xw [T, B, 4H], rw
// [H, 4H], p [3, H], h0/c0 [B, H], mask [T, B]; out hs [T, B, H], hT/cT
// [B, H] and, when `residuals`, cs [T, B, H] and gates [T, B, 4H] (else
// those two may be null). Returns 0 or a cudaError_t.
int dl4j_lstm_fwd(const void* xw, const void* rw, const void* p,
                  const void* h0, const void* c0, const void* mask, void* hs,
                  void* cs, void* gates, void* hT, void* cT, int T, int B,
                  int H, int residuals, int dtype, void* stream) {
  if (bad_shape(T, B, H) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (residuals && (cs == nullptr || gates == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  const auto fn = dtype == 1
      ? (residuals ? launch_fwd1<BF, true> : launch_fwd1<BF, false>)
      : (residuals ? launch_fwd1<float, true> : launch_fwd1<float, false>);
  return (int)fn(xw, rw, p, h0, c0, mask, hs, cs, gates, hT, cT, T, B, H,
                 st);
}

// Design 2 of B2a (`residuals`) and B2b: the persistent grid, `rows`
// batch rows a block (64, 32, 16 or 8; ops/lstm.py `b2_rows` chooses it
// from the shape). The arguments of `dl4j_lstm_fwd`, and hbuf [2, H, Bp]
// float32 scratch (Bp = B rounded up to `rows`) and counters [Bp / rows]
// uint32 zeros. Returns 0 or a cudaError_t (cudaErrorCooperativeLaunchTooLarge
// where the grid cannot be resident at once).
int dl4j_lstm_fwd_persistent(const void* xw, const void* rw, const void* p,
                             const void* h0, const void* c0,
                             const void* mask, void* hs, void* cs,
                             void* gates, void* hT, void* cT, void* hbuf,
                             void* counters, int T, int B, int H, int rows,
                             int residuals, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (residuals && (cs == nullptr || gates == nullptr))
    return (int)cudaErrorInvalidValue;
  using F = const float*;
  const persist::Args a{
      static_cast<F>(xw), static_cast<F>(rw), static_cast<F>(p),
      static_cast<F>(h0), static_cast<F>(c0), static_cast<F>(mask),
      static_cast<float*>(hs), static_cast<float*>(cs),
      static_cast<float*>(gates), static_cast<float*>(hT),
      static_cast<float*>(cT), static_cast<float*>(hbuf),
      static_cast<unsigned*>(counters), T, B, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define DL4J_LSTM_PERSIST(R)                                                \
  e = residuals ? persist::launch<R, true>(a, st)                           \
                : persist::launch<R, false>(a, st)
  switch (rows) {
    case 64: DL4J_LSTM_PERSIST(64); break;
    case 32: DL4J_LSTM_PERSIST(32); break;
    case 16: DL4J_LSTM_PERSIST(16); break;
    case 8: DL4J_LSTM_PERSIST(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_LSTM_PERSIST
  return (int)e;
}

// Design 2 of B2a (`residuals`) and B2b in bfloat16: the persistent grid
// with the product on the tensor cores, `rows` batch rows a block (64, 32,
// 16 or 8; ops/lstm.py `b2_rows` with esize 2 chooses it). Every tensor
// bfloat16, RW too, as `dl4j_lstm_fwd` takes them; hbuf [2, Bp, hk]
// bfloat16 ZEROS (Bp = B rounded up to `rows`, hk = H rounded up to 16)
// and counters [Bp / rows] uint32 zeros. Returns 0 or a cudaError_t.
int dl4j_lstm_fwd_persistent_bf16(const void* xw, const void* rw,
                                  const void* p, const void* h0,
                                  const void* c0, const void* mask, void* hs,
                                  void* cs, void* gates, void* hT, void* cT,
                                  void* hbuf, void* counters, int T, int B,
                                  int H, int rows, int residuals,
                                  void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (residuals && (cs == nullptr || gates == nullptr))
    return (int)cudaErrorInvalidValue;
  using C = const __nv_bfloat16*;
  using W = __nv_bfloat16*;
  const persist::ArgsBf16 a{
      static_cast<C>(xw), static_cast<C>(rw), static_cast<C>(p),
      static_cast<C>(h0), static_cast<C>(c0), static_cast<C>(mask),
      static_cast<W>(hs), static_cast<W>(cs), static_cast<W>(gates),
      static_cast<W>(hT), static_cast<W>(cT), static_cast<W>(hbuf),
      static_cast<unsigned*>(counters), T, B, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define DL4J_LSTM_PERSIST_BF16(R)                                           \
  e = residuals ? persist::launch_bf16<R, true>(a, st)                      \
                : persist::launch_bf16<R, false>(a, st)
  switch (rows) {
    case 64: DL4J_LSTM_PERSIST_BF16(64); break;
    case 32: DL4J_LSTM_PERSIST_BF16(32); break;
    case 16: DL4J_LSTM_PERSIST_BF16(16); break;
    case 8: DL4J_LSTM_PERSIST_BF16(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_LSTM_PERSIST_BF16
  return (int)e;
}

// The reverse-time recurrence of B2c, design 1. Contiguous, of `dtype`
// (0 float32, 1 bfloat16) but rwT and dp_part, float32 in both: dhs [T, B,
// H], gates [T, B, 4H], cs [T, B, H], rwT [4H, H] (RW transposed), p [3,
// H], mask [T, B], dhT/dcT/c0 [B, H]; out dxw [T, B, 4H], dh0/dc0 [B, H],
// dp_part [ceil(B / tile), 3, H].

int dl4j_lstm_bwd(const void* dhs, const void* gates, const void* cs,
                  const void* rwT, const void* p, const void* mask,
                  const void* dhT, const void* dcT, const void* c0,
                  void* dxw, void* dh0, void* dc0, void* dp_part, int T,
                  int B, int H, int dtype, void* stream) {
  if (bad_shape(T, B, H) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == 1 ? launch_bwd1<__nv_bfloat16> : launch_bwd1<float>)(
      dhs, gates, cs, rwT, p, mask, dhT, dcT, c0, dxw, dh0, dc0, dp_part, T,
      B, H, static_cast<cudaStream_t>(stream));
}

// The weight gradients of B2c, design 1, after the recurrence: drw [H, 4H]
// from hs [T, B, H], h0 [B, H] and dxw [T, B, 4H], all of `dtype` (0
// float32, 1 bfloat16); dp [3, H] of `dtype` from the float32 dp_part
// [tiles, 3, H].

int dl4j_lstm_bwd_weights(const void* hs, const void* h0, const void* dxw,
                          const void* dp_part, void* drw, void* dp, int T,
                          int B, int H, int tiles, int dtype, void* stream) {
  if (bad_shape(T, B, H) || tiles < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == 1 ? launch_weights1<__nv_bfloat16>
                          : launch_weights1<float>)(
      hs, h0, dxw, dp_part, drw, dp, T, B, H, tiles,
      static_cast<cudaStream_t>(stream));
}

// Design 2 of B2c's recurrence: the persistent grid, `rows` batch rows a
// block (64, 32, 16 or 8; ops/lstm.py `b2c_rows` chooses it). The
// arguments of `dl4j_lstm_bwd` with RW itself [H, 4H] in place of rwT,
// dp_part [Bp / rows, 3, H] (Bp = B rounded up to `rows`), and scratch:
// part [2, ceil(H / (256 / rows)), Bp, Hp] float32 (Hp = H rounded up to
// 4) and counters [Bp / rows] uint32 zeros. Returns 0 or a cudaError_t
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be resident).
int dl4j_lstm_bwd_persistent(const void* dhs, const void* gates,
                             const void* cs, const void* rw, const void* p,
                             const void* mask, const void* dhT,
                             const void* dcT, const void* c0, void* dxw,
                             void* dh0, void* dc0, void* dp_part, void* part,
                             void* counters, int T, int B, int H, int rows,
                             void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  using F = const float*;
  const persist::BwdArgs a{
      static_cast<F>(dhs), static_cast<F>(gates), static_cast<F>(cs),
      static_cast<F>(rw), static_cast<F>(p), static_cast<F>(mask),
      static_cast<F>(dhT), static_cast<F>(dcT), static_cast<F>(c0),
      static_cast<float*>(dxw), static_cast<float*>(dh0),
      static_cast<float*>(dc0), static_cast<float*>(dp_part),
      static_cast<float*>(part), static_cast<unsigned*>(counters), T, B, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 64: return (int)persist::launch_bwd<64>(a, st);
    case 32: return (int)persist::launch_bwd<32>(a, st);
    case 16: return (int)persist::launch_bwd<16>(a, st);
    case 8: return (int)persist::launch_bwd<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Design 2 of B2c's recurrence in bfloat16: the persistent grid with the
// product on the tensor cores, `rows` batch rows a block (64, 32, 16 or 8;
// ops/lstm.py `b2c_rows` with esize 2 chooses it). The arguments of
// `dl4j_lstm_bwd_persistent`, every tensor bfloat16 (RW [H, 4H] as it is)
// but dp_part [Bp / rows, 3, H] and the scratch part [2, ceil(H / (256 /
// rows)), Bp, hk] float32 (hk = H rounded up to 16); counters [Bp / rows]
// uint32 zeros. Returns 0 or a cudaError_t.
int dl4j_lstm_bwd_persistent_bf16(const void* dhs, const void* gates,
                                  const void* cs, const void* rw,
                                  const void* p, const void* mask,
                                  const void* dhT, const void* dcT,
                                  const void* c0, void* dxw, void* dh0,
                                  void* dc0, void* dp_part, void* part,
                                  void* counters, int T, int B, int H,
                                  int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  using C = const __nv_bfloat16*;
  using W = __nv_bfloat16*;
  const persist::BwdArgsBf16 a{
      static_cast<C>(dhs), static_cast<C>(gates), static_cast<C>(cs),
      static_cast<C>(rw), static_cast<C>(p), static_cast<C>(mask),
      static_cast<C>(dhT), static_cast<C>(dcT), static_cast<C>(c0),
      static_cast<W>(dxw), static_cast<W>(dh0), static_cast<W>(dc0),
      static_cast<float*>(dp_part), static_cast<float*>(part),
      static_cast<unsigned*>(counters), T, B, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 64: return (int)persist::launch_bwd_bf16<64>(a, st);
    case 32: return (int)persist::launch_bwd_bf16<32>(a, st);
    case 16: return (int)persist::launch_bwd_bf16<16>(a, st);
    case 8: return (int)persist::launch_bwd_bf16<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Design 2 of B2c's weight gradients: drw [H, 4H] by the pipelined SGEMM
// over `splits` slices of K = T·B (ops/lstm.py `b2c_splits`), then dp [3,
// H] from dp_part [tiles, 3, H] as design 1. Scratch: part [splits, H, 4H]
// float32 (unused, and may be null, at splits 1) and counters
// [ceil(H / 128) x ceil(4H / 128)] uint32 zeros.
int dl4j_lstm_bwd_weights_pipelined(const void* hs, const void* h0,
                                    const void* dxw, const void* dp_part,
                                    void* drw, void* dp, void* part,
                                    void* counters, int T, int B, int H,
                                    int tiles, int splits, void* stream) {
  if (T < 1 || B < 1 || H < 1 || tiles < 1 || splits < 1 || splits > 65535
      || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using F = const float*;
  cudaError_t e = (H % 4 == 0 ? pipe::launch<true> : pipe::launch<false>)(
      static_cast<F>(hs), static_cast<F>(h0), static_cast<F>(dxw),
      static_cast<float*>(drw), static_cast<float*>(part),
      static_cast<unsigned*>(counters), T, B, H, splits, st);
  if (e != cudaSuccess) return (int)e;
  lstm_dp_reduce_kernel<float><<<(3 * H + 255) / 256, 256, 0, st>>>(
      static_cast<F>(dp_part), static_cast<float*>(dp), tiles, H);
  return (int)cudaGetLastError();
}

// Design 2 of B2c's weight gradients in bfloat16: drw [H, 4H] by the
// `wgmma` GEMM over `splits` slices of K = T·B's tiles, at most 8, one
// cluster a tile of drw (ops/lstm.py `b2c_wgmma_splits`), then dp [3, H]
// from dp_part [tiles, 3, H] as design 1. hs [T, B, H], h0 [B, H], dxw
// [T, B, 4H], drw and dp bfloat16, H a multiple of 8, 16-byte aligned.
// Returns 0 or a cudaError_t.
int dl4j_lstm_bwd_weights_wgmma(const void* hs, const void* h0,
                                const void* dxw, const void* dp_part,
                                void* drw, void* dp, int T, int B, int H,
                                int tiles, int splits, void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(hs) | reinterpret_cast<uintptr_t>(h0) |
        reinterpret_cast<uintptr_t>(dxw) | reinterpret_cast<uintptr_t>(drw)) &
       15) == 0;
  if (T < 1 || B < 1 || H < 8 || H % 8 || H > 65535 || tiles < 1 ||
      splits < 1 || splits > wg::kMaxSplits || !aligned ||
      (long long)T * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = wg::launch(hs, h0, dxw, drw, T, B, H, splits, st);
  if (e != cudaSuccess) return (int)e;
  lstm_dp_reduce_kernel<__nv_bfloat16><<<(3 * H + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dp_part), static_cast<__nv_bfloat16*>(dp),
      tiles, H);
  return (int)cudaGetLastError();
}

// How many clusters of `size` blocks (1 to 8: the slices of one tile) of
// the bfloat16 weight product the current card runs at once: a cluster's
// blocks share a GPC, so this can fall short of SMs / size. Returns the
// count, or minus a cudaError_t.
int dl4j_lstm_wgmma_max_clusters(int size) {
  if (size < 1 || size > wg::kMaxSplits) return -(int)cudaErrorInvalidValue;
  cudaError_t e = wg::raise_smem();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wg::config(dim3(1, 1, size), 0, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<void*>(wg::lstm_drw_wgmma_kernel), &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
