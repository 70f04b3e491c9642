// Banded (sliding-window) attention forward for Hopper (sm_90a):
//
//   banded_fwd_kernel — replaces the TPU kernel B4,
//     deeplearning4j_tpu/ops/banded_attention.py `_banded_kernel` (via
//     `banded_attention`): online-softmax attention over the band
//     q - w < k <= q (causal) or |q - k| < w (bidirectional), on the JAX
//     layouts q/o [B, T, H, Dh] and k/v [B, T, Hkv, Dh], H a multiple of
//     Hkv (grouped-query attention; Hkv == H is plain multi-head).
//
// There is no backward kernel: as in the JAX package, the gradient is a
// dense band-masked recompute outside any kernel.
//
// Bound. Two products (S = QK^T and PV) over the visible (query, key)
// pairs, 2 Dh flops a pair each: at B 8, H 8, T 2048, Dh 64 and w 256 that
// is 31.5 M pairs and 8.06 GFLOP against about 84 MB of q, k, v and o, so
// the kernel is bound by the float32 arithmetic rate, not by memory.
//
// Design. The TPU kernel's grid (batch x Hkv, Q blocks, band K blocks)
// carries its online-softmax state across the last, sequential grid axis;
// CUDA has no sequential grid axis, so one block of 256 threads owns one
// 64-row query tile of one (batch, query head) and loops itself over the
// key tiles that meet its band: causal from the tile of q0 - w + 1 to the
// tile holding q0 + 63, bidirectional up to q0 + 63 + w - 1, clipped to
// [0, T). So the work grows as T w, not T^2. The tile arithmetic is the
// flash forward's (attention_tiles.cuh): exact float32 FMA, Q/K/V tiles
// staged in shared memory as float32 (bfloat16 widened on staging), a
// 4 x 4 score tile a thread, head-dim tiles 32/64/128. GQA is native: the
// block of query head h reads kv head h / G straight from the [B, T, Hkv,
// Dh] layout by strides, so K/V are never broadcast to H heads; the G
// query heads of a group re-read the same band of K/V, which L2 serves.
// Shared memory is 69-118 KB, so each instantiation raises its dynamic
// limit once.
// That is design 1. Design 2 (namespace `folded`, below it) takes float32
// at Dh 32, 64 and 128 with G in {1, 2, 4, 8}: it folds the G heads of a
// group into one block's rows, as the TPU kernel's [G x Bq, Dh] query tile
// does, so K/V are staged once a group, streams the K/V tiles through a
// cp.async ring, gives each thread an 8 x 4 score tile and an 8-row
// output tile, and masks only the tiles the band cuts. bfloat16 stays on
// design 1 (its 64-key tiles are the blocks p is rounded against, C6).
// Not done yet: tensor cores (TF32 is an open question) and TMA.
//
// Numerics. As the TPU kernel: the mask value is -1e30 and the running
// max starts there; masked entries get p = 0 explicitly, since the first
// tile a row visits can lie wholly outside its band (its running max is
// then still -1e30, and exp(s - m) would give masked keys weight 1); l is
// clamped at 1e-30 before the division. In bfloat16 p meets V rounded to
// bfloat16 against the running max of this kernel's 64-key tiles, as the
// TPU kernel's `p.astype(v.dtype)` rounds it against its blocks' (C6).
// Build without --use_fast_math so expf and the division stay IEEE.

#include "attention_tiles.cuh"

namespace {

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
banded_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int T_, int H,
                  int Hkv, int Dh, int window, int causal, float scale) {
  using G = Geo<DM>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kTile * G::LD;
  float* sV = sK + kTile * G::LD;
  float* sP = sV + kTile * G::LD;
  const int tx = tx_(), ty = ty_();
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  // row t of this head lies at base + t * stride
  const size_t qs = (size_t)H * Dh, ks = (size_t)Hkv * Dh;
  const T* qb = q + ((size_t)b * T_ * H + h) * Dh;
  const T* kb = k + ((size_t)b * T_ * Hkv + hk) * Dh;
  const T* vb = v + ((size_t)b * T_ * Hkv + hk) * Dh;
  T* ob = o + ((size_t)b * T_ * H + h) * Dh;
  load_tile<T, DM>(sQ, qb, q0, T_, Dh, qs);

  float m[4], l[4], acc[4][G::NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < G::NO; ++c) acc[i][c] = 0.f;
  }
  // the band's key tiles (the TPU kernel's _kb_first and nkb); the
  // wrapper clips the window to T, so nothing here overflows
  const int lo = max(0, q0 - window + 1);
  const int hi = min(T_ - 1, q0 + kTile - 1 + (causal ? 0 : window - 1));
  for (int kt = lo / kTile; kt <= hi / kTile; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, DM>(sK, kb, k0, T_, Dh, ks);
    load_tile<T, DM>(sV, vb, k0, T_, Dh, ks);
    __syncthreads();
    float s[4][4];
    dot_tile<DM>(sQ, sK, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        vis[j] = kj < T_ && kj > qi - window &&
                 (causal ? kj <= qi : kj < qi + window);
        const float x = vis[j] ? s[i][j] * scale : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // explicit zero: a row whose band has not started yet has
        // m_new == -1e30, where exp(s - m_new) would be 1
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        // l sums the unrounded p; P·V takes it rounded (C6)
        sP[(ty * 4 + i) * kLDP + tx + 16 * j] = operand<T>(p);
        rs += p;
      }
      rs = group_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < G::NO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile<DM>(sP, sV, acc);
  }
  // o = acc / l, divided as the TPU kernel divides (not times 1 / l)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= T_) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < G::CH; ++j)
#pragma unroll
      for (int e = 0; e < G::VEC; ++e) {
        const int c = 16 * G::VEC * j + G::VEC * tx + e;
        if (c < Dh) store_f32(ob + (size_t)r * qs + c,
                              acc[i][j * G::VEC + e] / li);
      }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, T, H, Hkv, Dh, window, causal;
  float scale;
};

// Each launcher instantiation raises its kernel's dynamic shared-memory
// limit once (a function-local static is per instantiation).
template <typename T, int DM>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr int smem = (3 * kTile * Geo<DM>::LD + kTile * kLDP) * 4;
  static const cudaError_t once = cudaFuncSetAttribute(
      banded_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (once != cudaSuccess) return once;
  banded_fwd_kernel<T, DM>
      <<<dim3((a.T + kTile - 1) / kTile, a.B * a.H), kThreads, smem, st>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<T*>(a.o), a.T, a.H, a.Hkv,
          a.Dh, a.window, a.causal, a.scale);
  return cudaGetLastError();
}

// the smallest head-dim tile that holds Dh
template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t st) {
  if (a.Dh <= 32) return launch<T, 32>(a, st);
  if (a.Dh <= 64) return launch<T, 64>(a, st);
  return launch<T, 128>(a, st);
}

// ===========================================================================
// Design 2 of B4: float32 at Dh 32, 64 or 128, G = H / Hkv in {1, 2, 4, 8}
// (`b4_design` in ops/banded_attention.py).
//
// Grid (ceil(T / BQ), B x Hkv). Block (i, (b, hk)) owns the 128 query rows
// r = p G + g of the G heads hk G + g at the BQ = 128 / G positions
// q0 + p (q0 = i BQ), the TPU kernel's folded [G x Bq, Dh] tile, so each K/V
// tile it stages serves all G heads (design 1 stages it G times). The
// blocks run from the end of the sequence backwards, so the short blocks of
// its first window come last. The band's key tiles of 32 keys, from the
// one holding q0 - w + 1 to the one holding the last visible key, stream
// through a ring of kStages tiles filled by cp.async.cg, 16 bytes a thread
// (keys past T zero-filled), so two tiles are in flight while one is
// folded: one barrier a tile frees a stage. Q is staged once, transposed
// (Q^T [Dh][128]), while the first tiles land.
// Thread (ty, tx) of 16 x 8 (a warp is 4 ty x 8 tx) owns the 8 rows
// 4 ty + e and 64 + 4 ty + e (e < 4), the 4 keys tx + 8 j of a tile, and
// the output columns 32 c + 4 tx + e. S = Q K^T: per 4 head-dim steps it
// reads 8 float4 of Q^T (4-row vectors, shared by the 8 tx lanes) and 4 of
// K rows (padded to Dh + 4, so the 8 tx lanes meet 8 bank groups) for 128
// FFMA. A row's max takes 3 shuffles among its 8 tx lanes; its sum stays
// a per-lane partial to the end. p goes to P^T [32][132] in shared memory
// as float4 of 4 rows; the rows a thread reads back for P V were written
// by its own warp, so a __syncwarp orders them. P V: per key 2 float4 of
// P^T and Dh / 32 float4 of V for 8 Dh / 4 FFMA.
// Which tiles need the mask is known per block before the loop: a tile is
// whole when its keys lie inside T and inside the band of every row of the
// block (first key > q0 + BQ - 1 - w; last key <= q0 causal, < q0 + w
// bidirectional); only the first tile and the diagonal ones are cut, and
// the rest take the path without the mask (`band_tile_whole`).
// Shared memory at Dh 64: Q^T 32 KB, three stages of K and V 49.5 KB, P^T
// 16.5 KB, 98 KB in all, so two blocks of 128 threads share an SM (one at
// Dh 128: two stages, 145.5 KB).
// Numerics as design 1 and the TPU kernel: float32 FMA, S summed over the
// head dim in order; the running max from -1e30; masked entries p = 0
// explicitly; l clamped at 1e-30; o = acc / l divided. p is taken on the
// SFU as 2^(s scale log2 e - m), the running max m kept in that base-2
// scale (`ex2.approx.ftz`, about 2 ulp; built with -DDL4J_BAND_EXPF=1 it
// is design 1's IEEE expf(s scale - m), `tools/torch_b4_exp_forms.py`
// times both and holds both to design 1's 2e-5). P V sums its 32-key
// tiles in key order, l its lanes' partials by a butterfly that gives
// every lane the same bits: a launch repeats its bits.
#ifndef DL4J_BAND_EXPF
#define DL4J_BAND_EXPF 0
#endif
namespace folded {

constexpr float kLog2e = 1.4426950408889634f;

// p and the running max's factor: 2^x on the SFU, or with the IEEE expf
// (x then in the natural scale)
__device__ __forceinline__ float exp_p(float x) {
#if DL4J_BAND_EXPF
  return expf(x);
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

constexpr int kThreads = 128;
constexpr int kRows = 128;       // G heads x BQ positions a block
constexpr int kBK = 32;          // keys a tile
constexpr int kLDP = kRows + 4;  // P^T row

template <int DH>
struct Geo {
  static constexpr int LDK = DH + 4;                  // padded K row
  static constexpr int kStages = DH == 128 ? 2 : 3;
  static constexpr int NC = DH / 32;                  // float4 columns a thread
  static constexpr int kQ = DH * kRows;               // floats of Q^T
  static constexpr int kStage = kBK * (LDK + DH);     // K, then V
  static constexpr int kP = kBK * kLDP;
  static constexpr int bytes = (kQ + kStages * kStage + kP) * 4;
  static constexpr int kMinBlocks = DH == 128 ? 1 : 2;
  static_assert(kBK * DH / 4 % kThreads == 0, "tile copies");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// The online-softmax step of one tile over this thread's scores s (8 rows
// x 4 keys), in place: s becomes p. kMasked applies the band and T per
// element; a whole tile skips it. `scale` includes log2 e in the SFU form.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[8],
                                             float (&l)[8], float (&alpha)[8],
                                             int q0, int k0, int ty, int tx,
                                             int gshift, int T_, int window,
                                             int causal, float scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + ((4 * ty + 64 * (i >> 2) + (i & 3)) >> gshift);
    bool vis[4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 8 * j;
      vis[j] = !kMasked || (kj < T_ && kj > qi - window &&
                            (causal ? kj <= qi : kj < qi + window));
      const float x = vis[j] ? s[i][j] * scale : kNegInf;
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = exp_p(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // explicit zero: a row whose band has not started has m_new -1e30
      const float p = vis[j] ? exp_p(s[i][j] - m_new) : 0.f;
      s[i][j] = p;
      rs += p;
    }
    l[i] = l[i] * alpha[i] + rs;
    m[i] = m_new;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, Geo<DH>::kMinBlocks)
banded_fwd_folded_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int T_, int H, int Hkv, int gshift, int window,
                         int causal, float scale) {
  using Gm = Geo<DH>;
  constexpr int LDK = Gm::LDK, NC = Gm::NC, S = Gm::kStages;
  constexpr int CPR = DH / 4;   // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // Q^T [DH][kRows]
  float* sKV = sQ + Gm::kQ;                      // stages: K, then V
  float* sP = sKV + S * Gm::kStage;              // P^T [kBK][kLDP]
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane & 7, ty = (tid >> 5) * 4 + (lane >> 3);
  const int BQ = kRows >> gshift;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y - b * Hkv;
  const size_t kvs = (size_t)Hkv * DH;
  const float* kb = k + ((size_t)b * T_ * Hkv + hk) * DH;
  const float* vb = v + ((size_t)b * T_ * Hkv + hk) * DH;
  // the band's key tiles (`band_key_tiles` with 32-key tiles)
  const int lo = max(0, q0 - window + 1);
  const int hi = min(T_ - 1, q0 + BQ - 1 + (causal ? 0 : window - 1));
  const int kt0 = lo / kBK, nt = hi / kBK - kt0 + 1;
  const float sl = DL4J_BAND_EXPF ? scale : scale * kLog2e;

  // the copies of tile `tile` into its stage, as one commit group (empty
  // past the last tile, so that the group count stays in step)
  auto issue = [&](int tile) {
    if (tile < nt) {
      float* sK = sKV + (tile % S) * Gm::kStage;
      float* sV = sK + kBK * LDK;
      const int k0 = (kt0 + tile) * kBK;
#pragma unroll
      for (int i = 0; i < kBK * CPR / kThreads; ++i) {
        const int j = tid + i * kThreads;
        const int r = j / CPR, c = j % CPR;
        const bool live = k0 + r < T_;
        const size_t off = (size_t)(live ? k0 + r : 0) * kvs + 4 * c;
        cp_async16(sK + r * LDK + 4 * c, kb + off, live);
        cp_async16(sV + r * DH + 4 * c, vb + off, live);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < S - 1; ++t) issue(t);

  // Q^T, one row a thread, while the first tiles land (rows past T zeros)
  {
    const int r = tid, p = q0 + (r >> gshift);
    const float4* src = reinterpret_cast<const float4*>(
        q + (((size_t)b * T_ + p) * H + ((size_t)hk << gshift) +
             (r & ((1 << gshift) - 1))) * DH);
#pragma unroll
    for (int c = 0; c < CPR; ++c) {
      const float4 x = p < T_ ? __ldg(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      sQ[(4 * c) * kRows + r] = x.x;
      sQ[(4 * c + 1) * kRows + r] = x.y;
      sQ[(4 * c + 2) * kRows + r] = x.z;
      sQ[(4 * c + 3) * kRows + r] = x.w;
    }
  }

  float acc[8][4 * NC], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int tile = 0; tile < nt; ++tile) {
    cp_async_wait<S - 2>();
    __syncthreads();   // tile landed (and Q^T); every warp is done with tile - 1
    issue(tile + S - 1);
    const float* sK = sKV + (tile % S) * Gm::kStage;
    const float* sV = sK + kBK * LDK;
    const int k0 = (kt0 + tile) * kBK;

    // S = Q K^T over this thread's 8 rows and 4 keys, the head dim in order
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(sK + (tx + 8 * j) * LDK + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(sQ + (d + e) * kRows + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(
            sQ + (d + e) * kRows + 64 + 4 * ty);
        const float qa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kk = lane_of(kf[j], e);
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i][j] = fmaf(qa[i], kk, s[i][j]);
        }
      }
    }

    float alpha[8];
    const bool whole = k0 + kBK <= T_ && k0 > q0 + BQ - 1 - window &&
                       (causal ? k0 + kBK - 1 <= q0
                               : k0 + kBK - 1 < q0 + window);
    if (whole)
      softmax_tile<false>(s, m, l, alpha, q0, k0, ty, tx, gshift, T_, window,
                          causal, sl);
    else
      softmax_tile<true>(s, m, l, alpha, q0, k0, ty, tx, gshift, T_, window,
                         causal, sl);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha[i];

    // p to P^T, 4 rows a float4; the rows this thread reads back were
    // written by its own warp
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = sP + (tx + 8 * j) * kLDP + 4 * ty;
      *reinterpret_cast<float4*>(dst) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 64) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncwarp();

    // acc += P V, the tile's keys in order
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p0 =
          *reinterpret_cast<const float4*>(sP + kk * kLDP + 4 * ty);
      const float4 p1 =
          *reinterpret_cast<const float4*>(sP + kk * kLDP + 64 + 4 * ty);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            sV + kk * DH + 32 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * c] = fmaf(pr[i], vv.x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // the empty groups past the last tile

  // o = acc / l (l: the 8 lanes' partials), divided as the TPU kernel does
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o_ = 1; o_ < 8; o_ <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o_);
    const float li = fmaxf(lt, 1e-30f);
    const int r = 4 * ty + 64 * (i >> 2) + (i & 3);
    const int p = q0 + (r >> gshift);
    if (p >= T_) continue;
    float* dst = o + (((size_t)b * T_ + p) * H + ((size_t)hk << gshift) +
                      (r & ((1 << gshift) - 1))) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(dst + 32 * c + 4 * tx) =
          make_float4(acc[i][4 * c] / li, acc[i][4 * c + 1] / li,
                      acc[i][4 * c + 2] / li, acc[i][4 * c + 3] / li);
  }
}

// Each launcher instantiation raises its kernel's dynamic shared-memory
// limit once (a function-local static is per instantiation).
template <int DH>
cudaError_t launch(const Args& a, int gshift, cudaStream_t st) {
  constexpr int smem = Geo<DH>::bytes;
  static const cudaError_t once = cudaFuncSetAttribute(
      banded_fwd_folded_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (once != cudaSuccess) return once;
  const int bq = kRows >> gshift;
  banded_fwd_folded_kernel<DH>
      <<<dim3((a.T + bq - 1) / bq, a.B * a.Hkv), kThreads, smem, st>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<float*>(a.o), a.T, a.H,
          a.Hkv, gshift, a.window, a.causal, a.scale);
  return cudaGetLastError();
}

}  // namespace folded

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). window is
// clipped to T by the caller. Returns 0 or a cudaError_t code.
int dl4j_banded_attention(const void* q, const void* k, const void* v,
                          void* o, int B, int T, int H, int Hkv, int Dh,
                          int window, int causal, float scale, int dtype,
                          void* stream) {
  if (Dh < 1 || Dh > 128 || B < 0 || T < 0 || Hkv < 1 || H % Hkv != 0 ||
      window < 1 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const Args a{q, k, v, o, B, T, H, Hkv, Dh, window, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

// Design 2 (float32 only): Dh 32, 64 or 128, H / Hkv in {1, 2, 4, 8},
// q, k, v and o 16-byte aligned. Returns 0 or a cudaError_t code.
int dl4j_banded_attention_folded(const float* q, const float* k,
                                 const float* v, float* o, int B, int T,
                                 int H, int Hkv, int Dh, int window,
                                 int causal, float scale, void* stream) {
  const int G = Hkv >= 1 ? H / Hkv : 0;
  if ((Dh != 32 && Dh != 64 && Dh != 128) || B < 0 || T < 0 || Hkv < 1 ||
      H % Hkv != 0 || (G != 1 && G != 2 && G != 4 && G != 8) || window < 1 ||
      (long long)B * Hkv > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  const Args a{q, k, v, o, B, T, H, Hkv, Dh, window, causal, scale};
  const int gshift = __builtin_ctz(G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 32) return (int)folded::launch<32>(a, gshift, st);
  if (Dh == 64) return (int)folded::launch<64>(a, gshift, st);
  return (int)folded::launch<128>(a, gshift, st);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
