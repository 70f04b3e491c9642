// Fused LSTM sequence kernels for Hopper (sm_90a), float32.
//
//   lstm_fwd_kernel<true>  — replaces the TPU kernel B2a,
//     deeplearning4j_tpu/ops/lstm.py `_fwd_kernel`: the recurrence over all
//     T steps with the residuals the backward needs (hs, cs, the activated
//     gates) and the final carries hT, cT.
//   lstm_fwd_kernel<false> — replaces B2b, `_fwd_kernel_inference`: the
//     same recurrence, writing hs, hT and cT only.
//   lstm_bwd_kernel + lstm_drw_kernel + lstm_dp_reduce_kernel — replace
//     B2c, `_bwd_kernel`: reverse time, dxw, dh0, dc0, then dRW and dP.
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
// from L2 each step, and at most 8 clusters are resident at once. Keeping
// RW's strips resident in the shared memory of a persistent grid with a
// barrier a step is the next design.
//
// Numerics. expf and tanhf, no fast-math: 128 steps of drift would break
// the tolerance. A sum of H products is taken as Q interleaved partial
// sums; the plain version's matmul sums in another order.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <bool RESID>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ rw,
                const float* __restrict__ p, const float* __restrict__ h0,
                const float* __restrict__ c0, const float* __restrict__ mask,
                float* __restrict__ hs, float* __restrict__ cs,
                float* __restrict__ gates, float* __restrict__ hT,
                float* __restrict__ cT, int T, int B, int H, Geom geo,
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
          b0 + b < B ? h0[(size_t)(b0 + b) * H + k] : 0.f;
  float c_reg[2], h_reg[2];
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int row = b0 + 2 * rp + pi;
    const bool ok = col_ok && row < B;
    c_reg[pi] = ok ? c0[(size_t)row * H + j] : 0.f;
    h_reg[pi] = ok ? h0[(size_t)row * H + j] : 0.f;
  }
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (col_ok) {
    p0 = p[j];
    p1 = p[H + j];
    p2 = p[2 * H + j];
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
      m[pi] = ok ? mask[(size_t)t * B + row] : 0.f;
      const float* x = xw + ((size_t)t * B + (ok ? row : 0)) * H4
          + (ok ? j : 0);
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) xv[pi][gg] = ok ? x[gg * H] : 0.f;
    }
    float acc[4][kBT];      // [gate][batch row] of column jj
    const float4* hv = reinterpret_cast<const float4*>(h_buf[cur]);
    st.pass(hv, hv + H, acc);

    float* h_nxt = h_buf[cur ^ 1];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const int row = b0 + 2 * rp + pi;
      const float zi = pick(acc[0], rp, pi) + xv[pi][0];
      const float zf = pick(acc[1], rp, pi) + xv[pi][1];
      const float zg = pick(acc[2], rp, pi) + xv[pi][2];
      const float zo = pick(acc[3], rp, pi) + xv[pi][3];
      const float cp = c_reg[pi], hp = h_reg[pi];
      const float ig = sigm(zi + cp * p0);
      const float fg = sigm(zf + cp * p1);
      const float gg = tanhf(zg);
      const float c_new = fg * cp + ig * gg;
      const float og = sigm(zo + c_new * p2);
      const float h_new = og * tanhf(c_new);
      const float hn = m[pi] * h_new + (1.0f - m[pi]) * hp;
      const float cn = m[pi] * c_new + (1.0f - m[pi]) * cp;
      c_reg[pi] = cn;
      h_reg[pi] = hn;
      if (col_ok && row < B) {
        const size_t at = ((size_t)t * B + row) * H + j;
        hs[at] = hn;
        if (RESID) {
          cs[at] = cn;
          float* gt = gates + ((size_t)t * B + row) * H4 + j;
          gt[0] = ig;
          gt[H] = fg;
          gt[2 * H] = gg;
          gt[3 * H] = og;
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
      hT[(size_t)row * H + j] = h_reg[pi];
      cT[(size_t)row * H + j] = c_reg[pi];
    }
  }
}

// ----------------------------------------------------------------- backward
// rwT is RW transposed, [4H, H]; dp_part is [batch tiles, 3, H], one partial
// of dP a cluster, summed afterwards in tile order.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
lstm_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ gates,
                const float* __restrict__ cs, const float* __restrict__ rwT,
                const float* __restrict__ p, const float* __restrict__ mask,
                const float* __restrict__ dhT, const float* __restrict__ dcT,
                const float* __restrict__ c0, float* __restrict__ dxw,
                float* __restrict__ dh0, float* __restrict__ dc0,
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
    dh_reg[pi] = ok ? dhT[(size_t)row * H + j] : 0.f;
    dc_reg[pi] = ok ? dcT[(size_t)row * H + j] : 0.f;
  }
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (col_ok) {
    p0 = p[j];
    p1 = p[H + j];
    p2 = p[2 * H + j];
  }
  cluster.sync();     // every block of the cluster runs

  for (int t = T - 1; t >= 0; --t) {
    // phase 1: the gate gradients of rows 2 rp and 2 rp + 1 of column j,
    // written to dxw and pushed into every block's dg_s
    float pass_h[2], dgate[4][2];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const int row = b0 + 2 * rp + pi;
      float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, c_t = 0.f, c_prev = 0.f,
            dh_o = 0.f, m = 0.f;
      const bool ok = col_ok && row < B;
      if (ok) {
        const size_t at = ((size_t)t * B + row) * H + j;
        const float* gt = gates + ((size_t)t * B + row) * H4 + j;
        ig = gt[0];
        fg = gt[H];
        gg = gt[2 * H];
        og = gt[3 * H];
        c_t = cs[at];
        // the predecessor of step 0 is the initial carry
        c_prev = t == 0 ? c0[(size_t)row * H + j] : cs[at - (size_t)B * H];
        dh_o = dhs[at];
        m = mask[(size_t)t * B + row];
      }
      const float dh_in = dh_o + dh_reg[pi];
      const float dh_t = m * dh_in;
      pass_h[pi] = (1.0f - m) * dh_in;
      const float tanh_c = tanhf(c_t);
      const float do_pre = dh_t * tanh_c * og * (1.0f - og);
      const float dc_new = m * dc_reg[pi]
          + dh_t * og * (1.0f - tanh_c * tanh_c) + do_pre * p2;
      const float di_pre = dc_new * gg * ig * (1.0f - ig);
      const float df_pre = dc_new * c_prev * fg * (1.0f - fg);
      const float dg_pre = dc_new * ig * (1.0f - gg * gg);
      dc_reg[pi] = dc_new * fg + (1.0f - m) * dc_reg[pi] + di_pre * p0
          + df_pre * p1;
      dpa[0] += di_pre * c_prev;
      dpa[1] += df_pre * c_prev;
      dpa[2] += do_pre * c_t;
      if (ok) {
        float* dx = dxw + ((size_t)t * B + row) * H4 + j;
        dx[0] = di_pre;
        dx[H] = df_pre;
        dx[2 * H] = dg_pre;
        dx[3 * H] = do_pre;
      }
      dgate[0][pi] = di_pre;
      dgate[1][pi] = df_pre;
      dgate[2][pi] = dg_pre;
      dgate[3][pi] = do_pre;
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
      dh_reg[pi] = pass_h[pi] + z_s[jj * kBT + 2 * rp + pi];
    cluster.sync();     // every block is done with dg_s and z_s
  }

#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int row = b0 + 2 * rp + pi;
    if (col_ok && row < B) {
      dh0[(size_t)row * H + j] = dh_reg[pi];
      dc0[(size_t)row * H + j] = dc_reg[pi];
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

__global__ void __launch_bounds__(256)
lstm_drw_kernel(const float* __restrict__ hs, const float* __restrict__ h0,
                const float* __restrict__ dxw, float* __restrict__ drw,
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
          ? (kk < B ? h0[kk * H + m] : hs[(kk - B) * H + m]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int idx = threadIdx.x + i * 256;
      const int64_t kk = k0 + idx / kTileN;
      const int n = n0 + idx % kTileN;
      rb[i] = (kk < K && n < H4) ? dxw[kk * H4 + n] : 0.f;
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
      if (ncol < H4) drw[(size_t)mrow * H4 + ncol] = acc[i][j];
    }
  }
}

// dP[q, j] = the batch tiles' partials summed in tile order
__global__ void lstm_dp_reduce_kernel(const float* __restrict__ dp_part,
                                      float* __restrict__ dp, int tiles,
                                      int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * H) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += dp_part[(size_t)t * 3 * H + i];
  dp[i] = s;
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

}  // namespace

extern "C" {

// batch rows a cluster: the caller sizes dp_part [ceil(B / tile), 3, H]
int dl4j_lstm_batch_tile() { return kBT; }

// Contiguous float32: xw [T, B, 4H], rw [H, 4H], p [3, H], h0/c0 [B, H],
// mask [T, B]; out hs [T, B, H], hT/cT [B, H] and, when `residuals`, cs
// [T, B, H] and gates [T, B, 4H] (else those two may be null).
// Returns 0 or a cudaError_t.
int dl4j_lstm_fwd(const void* xw, const void* rw, const void* p,
                  const void* h0, const void* c0, const void* mask, void* hs,
                  void* cs, void* gates, void* hT, void* cT, int T, int B,
                  int H, int residuals, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  const Geom geo = geometry(H, 4);
  const int fixed = 2 * H * kBT;
  const int stages = stages_for(fixed);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)fixed + stages * kStageFloats);
  const dim3 grid(kCluster, (B + kBT - 1) / kBT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // each instantiation raises its own dynamic shared-memory limit, once
  static bool raised[2] = {false, false};
  cudaError_t e = residuals
      ? raise_smem_limit(lstm_fwd_kernel<true>, &raised[1])
      : raise_smem_limit(lstm_fwd_kernel<false>, &raised[0]);
  if (e != cudaSuccess) return (int)e;
#define DL4J_LSTM_FWD(R)                                                     \
  lstm_fwd_kernel<R><<<grid, 4 * geo.Hcp, smem, st>>>(                       \
      static_cast<const float*>(xw), static_cast<const float*>(rw),          \
      static_cast<const float*>(p), static_cast<const float*>(h0),           \
      static_cast<const float*>(c0), static_cast<const float*>(mask),        \
      static_cast<float*>(hs), static_cast<float*>(cs),                      \
      static_cast<float*>(gates), static_cast<float*>(hT),                   \
      static_cast<float*>(cT), T, B, H, geo, stages)
  if (residuals) {
    if (cs == nullptr || gates == nullptr) return (int)cudaErrorInvalidValue;
    DL4J_LSTM_FWD(true);
  } else {
    DL4J_LSTM_FWD(false);
  }
#undef DL4J_LSTM_FWD
  return (int)cudaGetLastError();
}

// The reverse-time recurrence of B2c. Contiguous float32: dhs [T, B, H],
// gates [T, B, 4H], cs [T, B, H], rwT [4H, H] (RW transposed), p [3, H],
// mask [T, B], dhT/dcT/c0 [B, H]; out dxw [T, B, 4H], dh0/dc0 [B, H],
// dp_part [ceil(B / tile), 3, H].
int dl4j_lstm_bwd(const void* dhs, const void* gates, const void* cs,
                  const void* rwT, const void* p, const void* mask,
                  const void* dhT, const void* dcT, const void* c0,
                  void* dxw, void* dh0, void* dc0, void* dp_part, int T,
                  int B, int H, void* stream) {
  if (bad_shape(T, B, H)) return (int)cudaErrorInvalidValue;
  const Geom geo = geometry(H, 1);
  const int fixed = 4 * H * kBT + kBT * geo.Hcp;
  const int stages = stages_for(fixed);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)fixed + stages * kStageFloats);
  const dim3 grid(kCluster, (B + kBT - 1) / kBT);
  static bool raised = false;
  cudaError_t e = raise_smem_limit(lstm_bwd_kernel, &raised);
  if (e != cudaSuccess) return (int)e;
  lstm_bwd_kernel<<<grid, 4 * geo.Hcp, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dhs), static_cast<const float*>(gates),
      static_cast<const float*>(cs), static_cast<const float*>(rwT),
      static_cast<const float*>(p), static_cast<const float*>(mask),
      static_cast<const float*>(dhT), static_cast<const float*>(dcT),
      static_cast<const float*>(c0), static_cast<float*>(dxw),
      static_cast<float*>(dh0), static_cast<float*>(dc0),
      static_cast<float*>(dp_part), T, B, H, geo, stages);
  return (int)cudaGetLastError();
}

// The weight gradients of B2c, after the recurrence: drw [H, 4H] from hs
// [T, B, H], h0 [B, H] and dxw [T, B, 4H]; dp [3, H] from dp_part
// [tiles, 3, H].
int dl4j_lstm_bwd_weights(const void* hs, const void* h0, const void* dxw,
                          const void* dp_part, void* drw, void* dp, int T,
                          int B, int H, int tiles, void* stream) {
  if (bad_shape(T, B, H) || tiles < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((4 * H + kTileN - 1) / kTileN, (H + kTileM - 1) / kTileM);
  lstm_drw_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(hs), static_cast<const float*>(h0),
      static_cast<const float*>(dxw), static_cast<float*>(drw), T, B, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lstm_dp_reduce_kernel<<<(3 * H + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dp_part), static_cast<float*>(dp), tiles, H);
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
