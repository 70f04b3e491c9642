// Blockwise (flash) attention, forward and backward, for Hopper (sm_90a).
// Three kernels over folded [BH, T, Dh] tensors:
//
//   flash_fwd_kernel       — replaces the TPU kernel B3a,
//     deeplearning4j_tpu/ops/attention.py `_flash_kernel`: online-softmax
//     attention; writes o and, for training, the per-row log-sum-exp
//     lse = m + log(l) (f32, [BH, Tq]).
//   flash_bwd_dkdv_kernel  — replaces B3b, `_flash_bwd_dkdv_kernel`: dK and
//     dV with one K/V tile pinned while the Q tiles are swept.
//   flash_bwd_dq_kernel    — replaces B3c, `_flash_bwd_dq_kernel`: dQ with
//     one Q tile pinned while the K tiles are swept.
//
// Each comes in two designs, and the backward pair in three, chosen per
// call by `b3_design` in ops/attention.py (by dtype, head dim, alignment
// and direction, before the launch; none falls back to another): design 1
// above; design 2, `tc::fwd_wgmma_kernel`, `tc::bwd_dkdv_wgmma_kernel` and
// `tc::bwd_dq_wgmma_kernel`, for bfloat16; and design 3,
// `tf32x3::fwd_tf32x3_kernel`, `tf32x3::bwd_dkdv_tf32x3_kernel` and
// `tf32x3::bwd_dq_tf32x3_kernel`, for float32, all below.
//
// The backward rematerializes each score tile from the saved lse, as the
// TPU kernels do (`_bwd_tile`): p = exp(s - L), ds = p * (dp - delta) *
// scale, with delta = rowsum(dO * O) computed by the caller in f32. The
// two-kernel split needs no atomics, so the backward is deterministic.
//
// Bound. Attention is matrix products over the visible (query, key) pairs:
// 2 products forward and 5 backward (S, dP, dV, dK, dQ), 2 Dh flops a pair
// each. At T 2048 and Dh 64 that is about 64 flops a byte moved, so the
// kernels are bound by the arithmetic rate, not by memory: 67 TFLOP/s on
// the FMA units in float32 (design 1), 989 on the tensor cores in bfloat16
// (design 2), 495 / 3 in float32 as three TF32 products (design 3).
//
// Float32 contract: no float32 operand is ever rounded to a single TF32
// term. The float32 forward and backward at Dh 64 and 128 run on design
// 3 (3xTF32, about 22 bits of each operand: as accurate as FMA), every
// other float32 shape on design 1 (FMA).
//
// Design 1. Float32 arithmetic on the FMA units; bfloat16 inputs are
// widened to float32 as they are staged and rounded once on output. One
// block of 256 threads owns a 64-row tile; its partner tiles (64 keys, or
// 64 queries in the dK/dV kernel) are staged in shared memory, float32,
// rows padded by 4 floats so that the 16-byte loads of neighbouring rows
// fall in distinct banks. Thread (ty, tx) of the 16 x 16 grid computes the
// 4 x 4 score entries of rows 4 ty + i and columns tx + 16 j, so a row's
// 64 scores live in one half-warp and its max and sum are two shuffle
// reductions; the score tile goes through shared memory (rows padded to
// 68) to the second product, where the thread owns 4 rows and Dh / 16
// output columns in registers (that tile arithmetic lives in
// attention_tiles.cuh, shared with the banded kernel B4). The head dim is
// a compile-time tile DM in {32, 64, 128}; the smallest that holds Dh is
// launched and columns past Dh are zeros. Any Tq and Tk work: rows and
// keys past the end are staged as zeros and masked out of the softmax
// (p = 0). A causal block stops at its last row's tile (the forward and
// dQ kernels) or starts at its first row's (dK/dV). Shared memory is
// 45-170 KB, above the 48 KB static limit, so each instantiation raises
// its dynamic limit once.
//
// Design 2 (bfloat16 at Dh 64 and 128, 16-byte aligned q, k, v and, for
// the backward, dO): the products on the tensor cores, `wgmma` m64nNk16
// with float32 accumulators, fed by TMA (128-byte swizzled 64 x 64 boxes
// of a 3-D [BH, T, Dh] tensor map, zero-filled past T). A block is two
// consumer warpgroups of 64 rows each and a producer warpgroup whose one
// warp keeps a ring of kStages streamed tiles in flight, guarded by
// full/empty mbarriers (csrc/hopper_gemm.cuh). dK/dV: the block's 128 keys
// pinned, Q and dO tiles (and their 64 lse and delta values) streamed;
// each warpgroup computes S^T and dP^T with its keys as the 64 rows, P^T
// and dS^T in registers, then dV += P^T dO and dK += dS^T Q with A taken
// from registers (P^T, dS^T rounded to bfloat16 in place: the
// accumulator fragment is the A fragment, `acc_to_a`) and B the streamed
// tile read N-major through the transpose bit. dQ: the block's 128
// queries pinned, K and V tiles streamed; S, dP, then dQ += dS K. The
// forward is the dQ loop without dO, dP and delta: S, the online softmax
// in registers, then O += P V.
// Causal: dead tiles are skipped and only tiles that cross the diagonal
// or an end are masked; the dK/dV grid puts the key blocks on y, so the
// first key blocks (which sweep the most Q tiles) start first, and the dQ
// grid reverses its query blocks for the same reason. The exponent is
// exp2 of the score times scale * log2 e less lse * log2 e. Each
// warpgroup's sweep is software-pipelined: tile i + 1's first products
// are issued right behind tile i's last, and only waited for at tile
// i + 1, while the other warpgroup's products fill the tensor cores
// during this one's softmax. ptxas serializes `wgmma`s (warnings C7515,
// C7518) where a product is in flight across a branch it cannot prove
// uniform, or where an accumulator is written outside the products; so
// the warpgroup index is broadcast with a shuffle, barrier waits and
// lane branches sit where nothing is in flight, the last tile is peeled,
// each product's first k-slice overwrites its accumulator (scale-d 0)
// instead of a zeroing, and P and dS go from the accumulators straight
// into the A fragments.
// Not done yet: a ping-pong of the two warpgroups' softmax phases — later
// work.
//
// Numerics. As the TPU kernels: the causal mask value is -1e30, the
// running max starts at -1e30, l is clamped at 1e-30 before the division
// and the log. In bfloat16 every design rounds p (forward: against the
// running max of its 64-key tile), and dS, to bfloat16 where they meet the
// second products, as the TPU kernels' `.astype` does (C6); l, the running
// statistics and dS itself come from the unrounded float32 p. Build
// without --use_fast_math so expf, logf and the division stay IEEE.

#include "attention_tiles.cuh"
#include "hopper_gemm.cuh"

namespace {

// Stage 64 per-row statistics (lse or delta); past n they are zeros.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int r0, int n) {
  if (threadIdx.x < kTile) {
    const int gr = r0 + threadIdx.x;
    dst[threadIdx.x] = gr < n ? src[gr] : 0.f;
  }
}

// Write a thread's 4 x NO accumulator rows r0 + 4 ty + i (scaled by
// mul[i]) into a row-major [n, Dh] output.
template <typename T, int DM>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int r0,
                                           int n, int Dh,
                                           const float (&acc)[4][Geo<DM>::NO],
                                           const float (&mul)[4]) {
  using G = Geo<DM>;
  const int tx = tx_(), ty = ty_();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < G::CH; ++j)
#pragma unroll
      for (int e = 0; e < G::VEC; ++e) {
        const int c = 16 * G::VEC * j + G::VEC * tx + e;
        if (c < Dh)
          store_f32(out + (size_t)r * Dh + c, acc[i][j * G::VEC + e] * mul[i]);
      }
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int Dh,
                 float scale, int causal) {
  using G = Geo<DM>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kTile * G::LD;
  float* sV = sK + kTile * G::LD;
  float* sP = sV + kTile * G::LD;
  const int tx = tx_(), ty = ty_();
  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const T* kb = k + bh * Tk * Dh;
  const T* vb = v + bh * Tk * Dh;
  load_tile<T, DM>(sQ, q + bh * Tq * Dh, q0, Tq, Dh, Dh);

  float m[4], l[4], acc[4][G::NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < G::NO; ++c) acc[i][c] = 0.f;
  }
  int nkt = (Tk + kTile - 1) / kTile;
  if (causal) nkt = min(nkt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, DM>(sK, kb, k0, Tk, Dh, Dh);
    load_tile<T, DM>(sV, vb, k0, Tk, Dh, Dh);
    __syncthreads();
    float s[4][4];
    dot_tile<DM>(sQ, sK, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kj > qi) x = kNegInf;
        s[i][j] = x;
        if (kj < Tk) mx = fmaxf(mx, x);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        // l sums the unrounded p; P·V takes it rounded (C6)
        const float p = kj < Tk ? expf(s[i][j] - m_new) : 0.f;
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
    if (r >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[bh * Tq + r] = m[i] + logf(li);
#pragma unroll
    for (int j = 0; j < G::CH; ++j)
#pragma unroll
      for (int e = 0; e < G::VEC; ++e) {
        const int c = 16 * G::VEC * j + G::VEC * tx + e;
        if (c < Dh)
          store_f32(o + (bh * Tq + r) * Dh + c, acc[i][j * G::VEC + e] / li);
      }
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Tq, int Tk, int Dh,
                      float scale, int causal) {
  using G = Geo<DM>;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * G::LD;
  float* sQ = sV + kTile * G::LD;
  float* sO = sQ + kTile * G::LD;        // dO tile
  float* sPt = sO + kTile * G::LD;       // P^T tile [key][query]
  float* sSt = sPt + kTile * kLDP;       // dS^T tile
  float* sL = sSt + kTile * kLDP;
  float* sD = sL + kTile;
  const int tx = tx_(), ty = ty_();
  const int k0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Tq * Dh;
  const T* ob = dout + bh * Tq * Dh;
  load_tile<T, DM>(sK, k + bh * Tk * Dh, k0, Tk, Dh, Dh);
  load_tile<T, DM>(sV, v + bh * Tk * Dh, k0, Tk, Dh, Dh);

  float dka[4][G::NO], dva[4][G::NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < G::NO; ++c) dka[i][c] = dva[i][c] = 0.f;
  const int nqt = (Tq + kTile - 1) / kTile;
  // causal: a Q tile whose last row is above this K tile's first row
  // sees none of it (the TPU kernel's `relevant` rule)
  const int qt0 = causal ? k0 / kTile : 0;
  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, DM>(sQ, qb, q0, Tq, Dh, Dh);
    load_tile<T, DM>(sO, ob, q0, Tq, Dh, Dh);
    load_rows(sL, lse + bh * Tq, q0, Tq);
    load_rows(sD, delta + bh * Tq, q0, Tq);
    __syncthreads();
    float st[4][4], dpt[4][4];
    dot_tile<DM>(sK, sQ, st);    // st[i][j] = k_(4ty+i) . q_(tx+16j)
    dot_tile<DM>(sV, sO, dpt);   // dpt[i][j] = v_(4ty+i) . do_(tx+16j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lc = tx + 16 * j;
        const int qc = q0 + lc;
        const bool live = kr < Tk && qc < Tq && (!causal || qc >= kr);
        const float p = live ? expf(st[i][j] * scale - sL[lc]) : 0.f;
        // dS from the unrounded p; both meet dO and Q rounded (C6)
        sPt[(ty * 4 + i) * kLDP + lc] = operand<T>(p);
        sSt[(ty * 4 + i) * kLDP + lc] =
            operand<T>(p * (dpt[i][j] - sD[lc]) * scale);
      }
    }
    __syncthreads();
    pv_tile<DM>(sPt, sO, dva);   // dV += P^T dO
    pv_tile<DM>(sSt, sQ, dka);   // dK += dS^T Q
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, DM>(dk + bh * Tk * Dh, k0, Tk, Dh, dka, one);
  store_rows<T, DM>(dv + bh * Tk * Dh, k0, Tk, Dh, dva, one);
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int Tk, int Dh, float scale, int causal) {
  using G = Geo<DM>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + kTile * G::LD;        // dO tile
  float* sK = sO + kTile * G::LD;
  float* sV = sK + kTile * G::LD;
  float* sS = sV + kTile * G::LD;        // dS tile [query][key]
  float* sL = sS + kTile * kLDP;
  float* sD = sL + kTile;
  const int tx = tx_(), ty = ty_();
  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const T* kb = k + bh * Tk * Dh;
  const T* vb = v + bh * Tk * Dh;
  load_tile<T, DM>(sQ, q + bh * Tq * Dh, q0, Tq, Dh, Dh);
  load_tile<T, DM>(sO, dout + bh * Tq * Dh, q0, Tq, Dh, Dh);
  load_rows(sL, lse + bh * Tq, q0, Tq);
  load_rows(sD, delta + bh * Tq, q0, Tq);

  float dqa[4][G::NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < G::NO; ++c) dqa[i][c] = 0.f;
  int nkt = (Tk + kTile - 1) / kTile;
  if (causal) nkt = min(nkt, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, DM>(sK, kb, k0, Tk, Dh, Dh);
    load_tile<T, DM>(sV, vb, k0, Tk, Dh, Dh);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DM>(sQ, sK, s);     // s[i][j] = q_(4ty+i) . k_(tx+16j)
    dot_tile<DM>(sO, sV, dp);    // dp[i][j] = do_(4ty+i) . v_(tx+16j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int li = ty * 4 + i;
      const int qr = q0 + li;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool live = qr < Tq && kc < Tk && (!causal || kc <= qr);
        const float p = live ? expf(s[i][j] * scale - sL[li]) : 0.f;
        sS[li * kLDP + tx + 16 * j] =
            operand<T>(p * (dp[i][j] - sD[li]) * scale);
      }
    }
    __syncthreads();
    pv_tile<DM>(sS, sK, dqa);    // dQ += dS K
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, DM>(dq + bh * Tq * Dh, q0, Tq, Dh, dqa, one);
}

template <int DM>
constexpr int fwd_smem() {
  return (3 * kTile * Geo<DM>::LD + kTile * kLDP) * 4;
}
template <int DM>
constexpr int dkdv_smem() {
  return (4 * kTile * Geo<DM>::LD + 2 * kTile * kLDP + 2 * kTile) * 4;
}
template <int DM>
constexpr int dq_smem() {
  return (4 * kTile * Geo<DM>::LD + kTile * kLDP + 2 * kTile) * 4;
}

struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float* lse;
  const float* delta;
  int BH, Tq, Tk, Dh;
  float scale;
  int causal;
};

// Each launcher instantiation raises its kernel's dynamic shared-memory
// limit once (a function-local static is per instantiation).
template <typename T, int DM>
cudaError_t launch_fwd(const Args& a, cudaStream_t st) {
  constexpr int smem = fwd_smem<DM>();
  static const cudaError_t once = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (once != cudaSuccess) return once;
  flash_fwd_kernel<T, DM>
      <<<dim3((a.Tq + kTile - 1) / kTile, a.BH), kThreads, smem, st>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.Tq,
          a.Tk, a.Dh, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t launch_dkdv(const Args& a, cudaStream_t st) {
  constexpr int smem = dkdv_smem<DM>();
  static const cudaError_t once = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (once != cudaSuccess) return once;
  flash_bwd_dkdv_kernel<T, DM>
      <<<dim3((a.Tk + kTile - 1) / kTile, a.BH), kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Tq, a.Tk,
      a.Dh, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t launch_dq(const Args& a, cudaStream_t st) {
  constexpr int smem = dq_smem<DM>();
  static const cudaError_t once = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (once != cudaSuccess) return once;
  flash_bwd_dq_kernel<T, DM>
      <<<dim3((a.Tq + kTile - 1) / kTile, a.BH), kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.Tq, a.Tk, a.Dh, a.scale, a.causal);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDkdv = 1, kDq = 2 };

// the smallest head-dim tile that holds Dh
template <typename T>
cudaError_t dispatch(Which w, const Args& a, cudaStream_t st) {
  if (a.Dh <= 32) {
    return w == kFwd ? launch_fwd<T, 32>(a, st)
         : w == kDkdv ? launch_dkdv<T, 32>(a, st) : launch_dq<T, 32>(a, st);
  }
  if (a.Dh <= 64) {
    return w == kFwd ? launch_fwd<T, 64>(a, st)
         : w == kDkdv ? launch_dkdv<T, 64>(a, st) : launch_dq<T, 64>(a, st);
  }
  return w == kFwd ? launch_fwd<T, 128>(a, st)
       : w == kDkdv ? launch_dkdv<T, 128>(a, st) : launch_dq<T, 128>(a, st);
}

int run(Which w, const Args& a, int dtype, void* stream) {
  if (a.Dh < 1 || a.Dh > 128 || a.Tq < 0 || a.Tk < 1 || a.BH < 0 ||
      a.BH > 65535 || (a.causal && a.Tq != a.Tk))
    return (int)cudaErrorInvalidValue;
  if (a.BH == 0 || a.Tq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(w, a, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(w, a, st);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------------
// Design 2 of B3a, B3b and B3c: bfloat16 on the tensor cores (wgmma fed by
// TMA)
// ------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kThreads = 384;          // warpgroups 0, 1 compute; 2 loads
constexpr int kBox = 64 * 64 * 2;      // a 64 x 64 bfloat16 TMA box: 8 KB
constexpr int kStages = 3;             // depth of the streamed-tile ring
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row tile of a [BH, T, DH] operand is DH / 64 boxes of 64 columns,
// each 64 rows of 128 bytes, 128B-swizzled, kBox apart.
template <int DH>
struct Tile {
  static constexpr int kChunks = DH / 64;
  static constexpr int kBytes = kChunks * kBox;
  static constexpr int kAcc = DH / 2;  // floats of an m64nDH accumulator
  // setmaxnreg split of the 64K registers (2 x 128 consumers + 128
  // producers): dK, dV and the S, dP fragments at DH 128 need 240
  static constexpr int kConsumerRegs = DH == 128 ? 240 : 224;
  static constexpr int kProducerRegs = DH == 128 ? 24 : 56;
};

// descriptor of k16 slice kk of a K-major tile (A, or B with kTransB 0):
// box kk / 4, 32 bytes a slice along the swizzled 128-byte rows
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kBox + (kk & 3) * 32, 16, 1024);
}
// descriptor of k16 slice kk (rows 16 kk ..) of an N-major B tile whose
// N = DH columns are its boxes, kBox apart
__device__ __forceinline__ uint64_t nmajor(const uint8_t* tile, int kk) {
  return sw128_desc(tile + kk * 2048, kBox, 1024);
}

// issue the loads of one 64-row tile (all its boxes) of a [BH, T, DH] map
template <int DH>
__device__ __forceinline__ void load_tile_tma(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int bh) {
#pragma unroll
  for (int c = 0; c < Tile<DH>::kChunks; ++c)
    tma_load_3d(dst + c * kBox, map, bar, 64 * c, row, bh);
}

// an m64nDH float32 accumulator of rows r0 + (fragment row) into a
// row-major [n, DH] bfloat16 output, rounded once; rows past n skipped
template <int DH>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ out,
                                          const float (&d)[DH / 2], int r0,
                                          int n, int lane, int warp) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + lane / 4 + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)r * DH + 8 * j +
                                   2 * (lane % 4)) =
          pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

template <int DH>
__host__ __device__ constexpr int dkdv_stage() {
  // Q tile, dO tile, 64 lse and 64 delta values
  return 2 * Tile<DH>::kBytes + 1024;
}
template <int DH>
__host__ __device__ constexpr int dkdv_smem() {
  return 1024 + 4 * Tile<DH>::kBytes + kStages * dkdv_stage<DH>() +
         8 * (2 * kStages + 1);
}
template <int DH>
__host__ __device__ constexpr int dq_smem() {
  return 1024 + 4 * Tile<DH>::kBytes + kStages * 2 * Tile<DH>::kBytes +
         8 * (2 * kStages + 1);
}

// B3b, design 2. Block (bh, kb) owns keys 128 kb .. + 127: warpgroup w
// the 64 from kw0 = 128 kb + 64 w, its K and V tiles loaded once. The
// producer warp streams the Q and dO tiles the block's keys see (causal:
// from the tile of its first key on) with their 64 lse (times log2 e) and
// 64 delta values through a ring of kStages. Per Q tile each warpgroup
// computes, transposed so that its keys are the M rows:
//   S^T = K Q^T, dP^T = V dO^T            (A, B K-major, from shared memory)
//   P^T = exp(S^T scale - lse[col]), dS^T = P^T (dP^T - delta[col]) scale
//   dV += P^T dO, dK += dS^T Q            (A from registers: P^T, dS^T
//                                          rounded to bfloat16; B N-major)
// with dK, dV in float32 registers across the sweep, rounded once.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Tq, int Tk,
                      float scale, int causal) {
  using G = Tile<DH>;
  constexpr int kStage = dkdv_stage<DH>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sK = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sV = sK + 2 * G::kBytes;
  uint8_t* ring = sV + 2 * G::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  const int bh = blockIdx.x, k0 = blockIdx.y * 128;
  // the warpgroup and warp broadcast from lane 0, so that the compiler
  // knows them uniform: loops bounded by them then keep the products in
  // flight across iterations asynchronous
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int warp = __shfl_sync(0xffffffffu, t / 32, 0);
  const int qt0 = causal ? k0 / 64 : 0;
  const int ntiles = (Tq + 63) / 64 - qt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);     // the TMA arrival + 32 lanes' stats
      mbar_init(&empty[s], 8);     // one arrival from each consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    reg_dealloc<G::kProducerRegs>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 4 * G::kBytes);
        for (int w = 0; w < 2; ++w) {
          load_tile_tma<DH>(sK + w * G::kBytes, &kmap, kv_full, k0 + 64 * w,
                            bh);
          load_tile_tma<DH>(sV + w * G::kBytes, &vmap, kv_full, k0 + 64 * w,
                            bh);
        }
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, round = i / kStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* st = ring + s * kStage;
        const int q0 = (qt0 + i) * 64;
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * G::kBytes);
          load_tile_tma<DH>(st, &qmap, &full[s], q0, bh);
          load_tile_tma<DH>(st + G::kBytes, &omap, &full[s], q0, bh);
        }
        float* stats = reinterpret_cast<float*>(st + 2 * G::kBytes);
        for (int r = lane; r < 64; r += 32) {
          const int q = q0 + r;
          const bool in = q < Tq;
          stats[r] = in ? lse[(size_t)bh * Tq + q] * kLog2e : 0.f;
          stats[64 + r] = in ? delta[(size_t)bh * Tq + q] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<G::kConsumerRegs>();
    const int kw0 = k0 + 64 * wg;
    const uint8_t* myK = sK + wg * G::kBytes;
    const uint8_t* myV = sV + wg * G::kBytes;
    const float sl2 = scale * kLog2e;
    float dka[G::kAcc], dva[G::kAcc];
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);
    // dead tiles (past Tk, or causal: every query of the tile before this
    // warpgroup's first key) form a prefix of the sweep; they are only
    // handed back
    auto dead = [&](int i) {
      return kw0 >= Tk || (causal && (qt0 + i) * 64 + 63 < kw0);
    };
    int first = 0;
    for (; first < ntiles && dead(first); ++first) {
      mbar_wait(&full[first % kStages], (first / kStages) & 1);
      if (lane == 0) mbar_arrive(&empty[first % kStages]);
    }
    // Software-pipelined over the live tiles: tile i + 1's S^T and dP^T
    // are issued right behind tile i's dV/dK products. Every wait on a
    // barrier and every branch on a lane sits where no product is in
    // flight, and the last tile is peeled (`next` false), so the issues
    // are never conditional: ptxas then keeps the products asynchronous.
    // Each first k-slice overwrites its accumulator (scale-d 0).
    float st[32] = {}, dpt[32] = {};
    auto issue_sdp = [&](int i) {
      const uint8_t* sq = ring + (i % kStages) * kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        WgmmaBf16<64, 0>::run(st, kmajor(myK, kk), kmajor(sq, kk),
                              kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        WgmmaBf16<64, 0>::run(dpt, kmajor(myV, kk),
                              kmajor(sq + G::kBytes, kk), kk > 0);
      wgmma_commit();
    };
    auto step = [&](int i, auto next) {
      const uint8_t* sq = ring + (i % kStages) * kStage;
      const uint8_t* so = sq + G::kBytes;
      const float* stats = reinterpret_cast<const float*>(so + G::kBytes);
      const int q0 = (qt0 + i) * 64;
      // S^T and dP^T of tile i, and the dV/dK products of tile i - 1,
      // are done; tile i - 1's stage is free
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      if (i > first && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
      // P^T (rows are keys, columns queries) and dS^T, 16 queries at a
      // time, straight into the rounded A fragments: the accumulators are
      // only read, never written, outside the products. Masks only on
      // the tiles that cross the diagonal or the ends: keys past Tk and
      // queries past Tq were zero-filled, so their scores are 0, not -inf.
      const bool edge = (causal && q0 < kw0 + 64) || q0 + 64 > Tq ||
                        kw0 + 64 > Tk;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float p[8], ds[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int x = 8 * kk + e;
          const int c = 8 * (x / 4) + 2 * (lane % 4) + (x & 1);
          float pe = exp2f(fmaf(st[x], sl2, -stats[c]));
          if (edge) {
            const int key = kw0 + 16 * warp + lane / 4 + 8 * ((x >> 1) & 1);
            const int q = q0 + c;
            if (key >= Tk || q >= Tq || (causal && q < key)) pe = 0.f;
          }
          p[e] = pe;
          ds[e] = pe * (dpt[x] - stats[64 + c]) * scale;
        }
        acc_to_a(p, 0, pa[kk]);
        acc_to_a(ds, 0, da[kk]);
      }
      if constexpr (decltype(next)::value)
        mbar_wait(&full[(i + 1) % kStages], ((i + 1) / kStages) & 1);
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();   // the A registers were just written
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaBf16RS<DH, 1>::run(dva, pa[kk], nmajor(so, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaBf16RS<DH, 1>::run(dka, da[kk], nmajor(sq, kk));
      wgmma_commit();
      if constexpr (decltype(next)::value) issue_sdp(i + 1);
    };
    if (first < ntiles) {
      mbar_wait(&full[first % kStages], (first / kStages) & 1);
      issue_sdp(first);
      int i = first;
      for (; i + 1 < ntiles; ++i) step(i, std::true_type{});
      step(i, std::false_type{});
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      if (lane == 0) mbar_arrive(&empty[i % kStages]);
    }
    store_acc<DH>(dk + (size_t)bh * Tk * DH, dka, kw0, Tk, lane, warp);
    store_acc<DH>(dv + (size_t)bh * Tk * DH, dva, kw0, Tk, lane, warp);
  }
}

// B3c, design 2. Block (bh, y) owns queries q0 .. q0 + 127, the last
// query blocks first (causal: they sweep the most key tiles): warpgroup w
// the 64 from qw0 = q0 + 64 w, its Q and dO tiles loaded once and its
// rows' lse and delta in registers. The producer streams the K and V tiles
// (causal: up to the tile of the block's last query). Per K tile:
//   S = Q K^T, dP = dO V^T                  (A, B K-major)
//   P = exp(S scale - lse[row]), dS = P (dP - delta[row]) scale
//   dQ += dS K                              (A from registers: dS rounded
//                                            to bfloat16; B N-major)
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Tq, int Tk,
                    float scale, int causal) {
  using G = Tile<DH>;
  constexpr int kStage = 2 * G::kBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sO = sQ + 2 * G::kBytes;
  uint8_t* ring = sO + 2 * G::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  uint64_t* qo_full = empty + kStages;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  // the warpgroup and warp broadcast from lane 0, so that the compiler
  // knows them uniform: loops bounded by them then keep the products in
  // flight across iterations asynchronous
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int warp = __shfl_sync(0xffffffffu, t / 32, 0);
  int nkt = (Tk + 63) / 64;
  if (causal) nkt = min(nkt, min(q0 + 127, Tq - 1) / 64 + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(qo_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    reg_dealloc<G::kProducerRegs>();
    if (t == 0) {
      mbar_expect_tx(qo_full, 4 * G::kBytes);
      for (int w = 0; w < 2; ++w) {
        load_tile_tma<DH>(sQ + w * G::kBytes, &qmap, qo_full, q0 + 64 * w,
                          bh);
        load_tile_tma<DH>(sO + w * G::kBytes, &omap, qo_full, q0 + 64 * w,
                          bh);
      }
      for (int i = 0; i < nkt; ++i) {
        const int s = i % kStages, round = i / kStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* st = ring + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        load_tile_tma<DH>(st, &kmap, &full[s], 64 * i, bh);
        load_tile_tma<DH>(st + G::kBytes, &vmap, &full[s], 64 * i, bh);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<G::kConsumerRegs>();
    const int qw0 = q0 + 64 * wg;
    const uint8_t* myQ = sQ + wg * G::kBytes;
    const uint8_t* myO = sO + wg * G::kBytes;
    const float sl2 = scale * kLog2e;
    // this thread's two rows: lse (times log2 e) and delta
    float rl[2], rd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = qw0 + 16 * warp + lane / 4 + 8 * h;
      rl[h] = q < Tq ? lse[(size_t)bh * Tq + q] * kLog2e : 0.f;
      rd[h] = q < Tq ? delta[(size_t)bh * Tq + q] : 0.f;
    }
    float dqa[G::kAcc];
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i) dqa[i] = 0.f;
    mbar_wait(qo_full, 0);
    // live tiles are a prefix of the sweep: none past Tq, and (causal)
    // none past this warpgroup's last query; the rest are only handed back
    const int nlive = qw0 >= Tq ? 0
                      : causal ? min(nkt, (qw0 + 63) / 64 + 1) : nkt;
    // Software-pipelined as the dK/dV kernel: tile i + 1's S and dP are
    // issued right behind tile i's dQ product.
    float sc[32] = {}, dp[32] = {};
    auto issue_sdp = [&](int i) {
      const uint8_t* sk = ring + (i % kStages) * kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        WgmmaBf16<64, 0>::run(sc, kmajor(myQ, kk), kmajor(sk, kk),
                              kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        WgmmaBf16<64, 0>::run(dp, kmajor(myO, kk),
                              kmajor(sk + G::kBytes, kk), kk > 0);
      wgmma_commit();
    };
    auto step = [&](int i, auto next) {
      const uint8_t* sk = ring + (i % kStages) * kStage;
      const int kt0 = 64 * i;
      // S and dP of tile i, and the dQ product of tile i - 1, are done
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % kStages]);
      const bool edge = (causal && kt0 + 63 > qw0) || kt0 + 64 > Tk ||
                        qw0 + 64 > Tq;
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float ds[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int x = 8 * kk + e;
          const int h = (x >> 1) & 1;
          float p = exp2f(fmaf(sc[x], sl2, -rl[h]));
          if (edge) {
            const int q = qw0 + 16 * warp + lane / 4 + 8 * h;
            const int key = kt0 + 8 * (x / 4) + 2 * (lane % 4) + (x & 1);
            if (key >= Tk || q >= Tq || (causal && key > q)) p = 0.f;
          }
          ds[e] = p * (dp[x] - rd[h]) * scale;
        }
        acc_to_a(ds, 0, da[kk]);
      }
      if constexpr (decltype(next)::value)
        mbar_wait(&full[(i + 1) % kStages], ((i + 1) / kStages) & 1);
      fence_regs(dqa);
      wgmma_fence();   // the A registers were just written
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaBf16RS<DH, 1>::run(dqa, da[kk], nmajor(sk, kk));
      wgmma_commit();
      if constexpr (decltype(next)::value) issue_sdp(i + 1);
    };
    if (nlive > 0) {
      mbar_wait(&full[0], 0);
      issue_sdp(0);
      int i = 0;
      for (; i + 1 < nlive; ++i) step(i, std::true_type{});
      step(i, std::false_type{});
      wgmma_wait<0>();
      fence_regs(dqa);
      if (lane == 0) mbar_arrive(&empty[i % kStages]);
    }
    for (int i = nlive; i < nkt; ++i) {
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      if (lane == 0) mbar_arrive(&empty[i % kStages]);
    }
    store_acc<DH>(dq + (size_t)bh * Tq * DH, dqa, qw0, Tq, lane, warp);
  }
}

// 2^x, subnormal results flushed to zero (p that small vanishes beside
// the row's largest p = 1)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p's exponential in B3a design 2: 2^(s scale log2 e - m log2 e) on the
// SFU (0, the default), or design 1's and the plain version's
// expf(s scale - m) (1); `tools/torch_b3a_exp_forms.py` builds both and
// holds each against the plain version
#ifndef DL4J_FWD_EXPF
#define DL4J_FWD_EXPF 0
#endif

// the forward's ring is a stage deeper: a stage is handed back a softmax
// later, once the P V that overlaps the next tile's softmax is done
constexpr int kFwdStages = 4;

template <int DH>
__host__ __device__ constexpr int fwd_smem() {
  return 1024 + 2 * Tile<DH>::kBytes + kFwdStages * 2 * Tile<DH>::kBytes +
         8 * (2 * kFwdStages + 1);
}

// B3a, design 2: B3c's loop with dO, dP and delta taken out. Block (bh, y)
// owns queries q0 .. q0 + 127, the last query blocks first (causal: they
// sweep the most key tiles): warpgroup w the 64 from qw0 = q0 + 64 w, its Q
// tile loaded once. The producer streams the K and V tiles (causal: up to
// the tile of the block's last query). Per K tile, with m and l a row's
// running max (of s scale) and row sum:
//   S = Q K^T                               (A, B K-major)
//   m' = max(m, max(S scale)), alpha = exp(m - m')
//   P = exp(S scale - m'), l = l alpha + rowsum(P)
//   A = P V                                 (A from registers: P rounded
//                                            to bfloat16; B N-major)
//   O = O alpha + A                         (once that product is done)
// then o = O / l (divided, rounded once) and lse = m + log(l). The running
// O lives in registers that no product writes, and each tile's P V starts
// its accumulator afresh (scale-d 0): an accumulator that other
// instructions write (an O rescaled in place) makes ptxas serialize the
// products (C7515). l is summed from the unrounded P over this thread's
// columns, and over the quad of lanes that shares a row at the end.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Tq, int Tk, float scale, int causal) {
  using G = Tile<DH>;
  constexpr int kStage = 2 * G::kBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sQ + 2 * G::kBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFwdStages * kStage);
  uint64_t* empty = full + kFwdStages;
  uint64_t* q_full = empty + kFwdStages;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  // the warpgroup and warp broadcast from lane 0, as in the dQ kernel
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int warp = __shfl_sync(0xffffffffu, t / 32, 0);
  int nkt = (Tk + 63) / 64;
  if (causal) nkt = min(nkt, min(q0 + 127, Tq - 1) / 64 + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    reg_dealloc<G::kProducerRegs>();
    if (t == 0) {
      mbar_expect_tx(q_full, 2 * G::kBytes);
      for (int w = 0; w < 2; ++w)
        load_tile_tma<DH>(sQ + w * G::kBytes, &qmap, q_full, q0 + 64 * w,
                          bh);
      for (int i = 0; i < nkt; ++i) {
        const int s = i % kFwdStages, round = i / kFwdStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* st = ring + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        load_tile_tma<DH>(st, &kmap, &full[s], 64 * i, bh);
        load_tile_tma<DH>(st + G::kBytes, &vmap, &full[s], 64 * i, bh);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    reg_alloc<G::kConsumerRegs>();
    const int qw0 = q0 + 64 * wg;
    const uint8_t* myQ = sQ + wg * G::kBytes;
    const float sl2 = scale * kLog2e;
    // this thread's two rows (h = 0, 1): running max and its share of l
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // ov: O; oa: the accumulator of a tile's P V, folded into O once done
    // (only the products write it); alpha_o: the rescale O takes before
    // that tile's P V is added
    float ov[G::kAcc], oa[G::kAcc], alpha_o[2];
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i) ov[i] = 0.f;
    mbar_wait(q_full, 0);
    // live tiles are a prefix of the sweep, as in the dQ kernel
    const int nlive = qw0 >= Tq ? 0
                      : causal ? min(nkt, qw0 / 64 + 1) : nkt;
    float sc[32] = {};
    auto issue_s = [&](int i) {
      const uint8_t* sk = ring + (i % kFwdStages) * kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        WgmmaBf16<64, 0>::run(sc, kmajor(myQ, kk), kmajor(sk, kk), kk > 0);
      wgmma_commit();
    };
    // Software-pipelined: tile i + 1's S is issued ahead of tile i's P V,
    // so that P V runs on the tensor cores during the next tile's softmax
    // (`wgmma_wait<1>` waits for S alone); the registers that P V reads
    // (its A fragments) and writes are touched only after `wgmma_wait<0>`.
    // Waits on barriers and lane branches sit where nothing is in flight
    // (the mask's branch is warp-uniform); the last tile is peeled.
    auto step = [&](int i, auto next) {
      const uint8_t* sv = ring + (i % kFwdStages) * kStage + G::kBytes;
      const int kt0 = 64 * i;
      wgmma_wait<1>();      // S of tile i is done; P V of tile i - 1 runs
      fence_regs(sc);
      // Keys past Tk (zero-filled: score 0, not -inf) and, causal, keys
      // past a row's query are masked: s = -inf, so p = 0, on the tiles
      // that cross the diagonal or the end only (a warp-uniform branch).
      // Column x of the fragment is key kt0 + 2 (lane % 4) + 8 (x / 4) +
      // (x & 1), so with lim[h] the last key row h sees less kt0 +
      // 2 (lane % 4), each test is a compare with a constant.
      const float kMinusInf = __int_as_float(0xff800000);
      float sm[32];
      if ((causal && kt0 + 63 > qw0) || kt0 + 64 > Tk) {
        int lim[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = qw0 + 16 * warp + lane / 4 + 8 * h;
          lim[h] = (causal ? min(Tk - 1, q) : Tk - 1) - kt0 - 2 * (lane % 4);
        }
#pragma unroll
        for (int x = 0; x < 32; ++x)
          sm[x] = 8 * (x / 4) + (x & 1) > lim[(x >> 1) & 1] ? kMinusInf
                                                            : sc[x];
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) sm[x] = sc[x];
      }
      // the row max of s (over this thread's 16 columns, then the quad of
      // lanes that holds the row), scaled once: scale > 0, so this is the
      // max of the scaled scores bit for bit
      float mx[2] = {kMinusInf, kMinusInf};
#pragma unroll
      for (int x = 0; x < 32; ++x)
        mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sm[x]);
      float alpha[2], ml2[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * scale);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        ml2[h] = m_new * kLog2e;
      }
      // P in float32 (S is only read); rounded into the A fragments only
      // once tile i - 1's P V is done, since that product still reads the
      // A registers
      float p[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        p[x] = DL4J_FWD_EXPF
                   ? expf(__fsub_rn(__fmul_rn(sm[x], scale), m[(x >> 1) & 1]))
                   : ex2_ftz(fmaf(sm[x], sl2, -ml2[(x >> 1) & 1]));
        rs[(x >> 1) & 1] += p[x];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
      wgmma_wait<0>();      // P V of tile i - 1 is done: fold it into O
      fence_regs(oa);
      fence_regs(p);        // the rounding below stays after the wait
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(p, kk, pa[kk]);
      if (i > 0) {
        if (lane == 0) mbar_arrive(&empty[(i - 1) % kFwdStages]);
#pragma unroll
        for (int x = 0; x < G::kAcc; ++x)
          ov[x] = fmaf(ov[x], alpha_o[(x >> 1) & 1], oa[x]);
      }
      alpha_o[0] = alpha[0];
      alpha_o[1] = alpha[1];
      if constexpr (decltype(next)::value) {
        mbar_wait(&full[(i + 1) % kFwdStages], ((i + 1) / kFwdStages) & 1);
        issue_s(i + 1);
      }
      fence_regs(oa);
      wgmma_fence();   // the A registers were just written
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaBf16RS<DH, 1>::run(oa, pa[kk], nmajor(sv, kk), kk > 0);
      wgmma_commit();
    };
    if (nlive > 0) {
      mbar_wait(&full[0], 0);
      issue_s(0);
      wgmma_commit();       // an empty group in place of tile -1's P V
      int i = 0;
      for (; i + 1 < nlive; ++i) step(i, std::true_type{});
      step(i, std::false_type{});
      wgmma_wait<0>();
      fence_regs(oa);
      if (lane == 0) mbar_arrive(&empty[i % kFwdStages]);
#pragma unroll
      for (int x = 0; x < G::kAcc; ++x)
        ov[x] = fmaf(ov[x], alpha_o[(x >> 1) & 1], oa[x]);
    }
    for (int i = nlive; i < nkt; ++i) {
      mbar_wait(&full[i % kFwdStages], (i / kFwdStages) & 1);
      if (lane == 0) mbar_arrive(&empty[i % kFwdStages]);
    }
    // o = O / l, divided as the TPU kernel divides (not times 1 / l)
    float li[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      li[h] = fmaxf(l[h], 1e-30f);
      const int q = qw0 + 16 * warp + lane / 4 + 8 * h;
      if (lse != nullptr && lane % 4 == 0 && q < Tq)
        lse[(size_t)bh * Tq + q] = m[h] + logf(li[h]);
    }
    __nv_bfloat16* ob = o + (size_t)bh * Tq * DH;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qw0 + 16 * warp + lane / 4 + 8 * h;
      if (r >= Tq) continue;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r * DH + 8 * j +
                                     2 * (lane % 4)) =
            pack_bf16(ov[4 * j + 2 * h] / li[h],
                      ov[4 * j + 2 * h + 1] / li[h]);
    }
  }
}

// 3-D [BH, T, DH] bfloat16 tensor map read in 64 x 64 boxes
int encode_rows(CUtensorMap* map, const void* base, int BH, int T, int DH) {
  const uint64_t dims[3] = {(uint64_t)DH, (uint64_t)T, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)DH * 2, (uint64_t)T * DH * 2};
  const uint32_t box[3] = {64, 64, 1};
  return encode_tensor_map(map, base, 3, dims, strides, box);
}

template <int DH>
int launch(Which w, const Args& a, cudaStream_t st) {
  CUtensorMap qm, km, vm, om;
  int rc = encode_rows(&qm, a.q, a.BH, a.Tq, DH);
  if (!rc) rc = encode_rows(&km, a.k, a.BH, a.Tk, DH);
  if (!rc) rc = encode_rows(&vm, a.v, a.BH, a.Tk, DH);
  if (!rc && w != kFwd) rc = encode_rows(&om, a.dout, a.BH, a.Tq, DH);
  if (rc) return rc;
  using B = __nv_bfloat16;
  if (w == kFwd) {
    constexpr int smem = fwd_smem<DH>();
    static const cudaError_t once = cudaFuncSetAttribute(
        fwd_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (once != cudaSuccess) return (int)once;
    fwd_wgmma_kernel<DH>
        <<<dim3(a.BH, (a.Tq + 127) / 128), kThreads, smem, st>>>(
            qm, km, vm, static_cast<B*>(a.o), a.lse, a.Tq, a.Tk, a.scale,
            a.causal);
  } else if (w == kDkdv) {
    constexpr int smem = dkdv_smem<DH>();
    static const cudaError_t once = cudaFuncSetAttribute(
        bwd_dkdv_wgmma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (once != cudaSuccess) return (int)once;
    bwd_dkdv_wgmma_kernel<DH>
        <<<dim3(a.BH, (a.Tk + 127) / 128), kThreads, smem, st>>>(
            qm, km, vm, om, a.lse, a.delta, static_cast<B*>(a.dk),
            static_cast<B*>(a.dv), a.Tq, a.Tk, a.scale, a.causal);
  } else {
    constexpr int smem = dq_smem<DH>();
    static const cudaError_t once = cudaFuncSetAttribute(
        bwd_dq_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (once != cudaSuccess) return (int)once;
    bwd_dq_wgmma_kernel<DH>
        <<<dim3(a.BH, (a.Tq + 127) / 128), kThreads, smem, st>>>(
            qm, km, vm, om, a.lse, a.delta, static_cast<B*>(a.dq), a.Tq,
            a.Tk, a.scale, a.causal);
  }
  return (int)cudaGetLastError();
}

int run(Which w, const Args& a, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.dout);
  if ((a.Dh != 64 && a.Dh != 128) || (ptrs & 15) || a.Tq < 0 ||
      a.Tk < 1 || a.BH < 0 || (a.causal && a.Tq != a.Tk) ||
      (a.Tq + 127) / 128 > 65535 || (a.Tk + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.BH == 0 || a.Tq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.Dh == 64 ? launch<64>(w, a, st) : launch<128>(w, a, st);
}

}  // namespace tc

// ------------------------------------------------------------------------
// Design 3 of B3a, B3b and B3c: float32 on the tensor cores as 3xTF32
// ------------------------------------------------------------------------
// Float32 at Dh 64 and 128 with q, k, v and dO 16-byte aligned. Design 1
// runs its products on the FMA units (67 TFLOP/s on an H100) from 4 x 4
// micro-tiles that read both operands from shared memory every few FMAs,
// stages its tiles synchronously and passes P (forward), P^T and dS^T
// (backward) through shared memory. Here the products run on the tensor
// cores, `mma.sync` m16n8k8 with tf32 operands and float32 accumulators.
// Each float32 operand x is split into big = tf32(x) and small = tf32(x -
// big) (both rounded to nearest, ties away, as `cvt.rna`), and each
// product is taken as small * big + big * small + big * big, the two
// small ones first (see "Sums" below for where each is added). That keeps
// about 22 bits of each operand: the result is as accurate as float32
// FMA, never the one-pass TF32 product (`ops/attention.py`
// `tf32x3_split` emulates the split on the CPU). Three TF32 products a
// float32 product: the bound is 495 / 3 TFLOP/s. `mma.sync` and not
// `wgmma`: `wgmma` reads tf32 operands from shared memory K-major only
// (the transpose bit is for 16-bit types), and the backward reads Q, dO
// and K transposed, the forward V; `mma.sync` fragments are loaded by
// index, so a transpose costs nothing.
//
// A block is 8 warps, one block an SM; a warp owns 16 rows of the
// block's 128-row pinned tile (keys in dK/dV, with K and V pinned;
// queries in dQ, with Q, dO, lse and delta pinned; queries in the
// forward, with Q pinned), loaded once. The streamed tiles of kCols rows
// (Q, dO and their lse and delta in dK/dV; K and V in dQ and the
// forward) come through a ring of kStages buffers filled by 16-byte
// `cp.async` (4-byte for lse and delta), the next tile in flight during
// this one's products. Every warp reads every element of a streamed tile
// as a B operand, and the split was most of the instructions; so at Dh 64
// (64-row tiles) the block splits each streamed tile once, in place (big)
// and into a plane of its own (small), behind a second barrier, and the
// fragments read both planes. At Dh 128 those planes do not fit beside
// the pinned tile: the streamed tiles are 32 rows (so that dK and dV's
// 128 accumulators leave room in the registers) and each warp splits its
// B fragments as it loads them. The forward splits its streamed K and V
// tiles at fragment load at both Dh: each is read by one product there,
// not two, and the split pass with its second barrier ran 6-7% slower at
// Dh 64 (`tools/torch_b3a_variants.py`, PERF.md). The pinned A operands
// (the forward's Q too: split once into two planes it ran within 4% of
// this, either way by shape) and P, P^T, dS^T are split as their
// fragments are loaded. Rows are padded to Dh + 4 floats, so every
// fragment read (a lane reads row g or 2t of 8, column t or g) falls in
// 32 distinct banks. Per streamed tile a warp computes, in the
// accumulator layout of a 16 x kCols m16n8 product (lane (g, t) holds
// rows g, g + 8 and columns 2t, 2t + 1 of each 8-column tile):
//   dK/dV: S^T = K Q^T, dP^T = V dO^T; P^T = exp(S^T scale - lse),
//          dS^T = P^T (dP^T - delta) scale; dV += P^T dO, dK += dS^T Q
//   dQ:    S = Q K^T, dP = dO V^T; P, dS likewise; dQ += dS K
//   fwd:   S = Q K^T; the online softmax (m, l, alpha); O = O alpha + P V
// P^T, dS^T and P stay in registers: an accumulator holds columns 2t and
// 2t + 1 of each 8-column tile where the A fragment of the next product
// wants columns t and t + 4, so the reduction index of that product is
// permuted (A column t <- 2t, t + 4 <- 2t + 1) and B's rows (dO, Q, K or
// V) are read in the same permuted order; a sum does not depend on the
// order of its terms. Causal: dead tiles are skipped (for a block, and for a
// warp whose 16 rows a tile near the diagonal does not reach), only tiles
// that cross the diagonal or an end are masked, and the blocks with the
// most tiles start first (dK/dV: key blocks on y, the first keys sweep
// the most Q tiles; dQ and the forward: query blocks reversed).
// Numerics as design 1: p = expf(s scale - lse) (IEEE: built without
// --use_fast_math), delta from the caller in float32, dS from the
// unrounded p, the mask value -1e30 (a masked p is 0); the forward's
// running max starts at -1e30, keys past Tk get p = 0, l is clamped at
// 1e-30, o = acc / l, lse = m + logf(l); no atomics, so two launches give
// the same bits. Nothing float32 is rounded to a single TF32 term.
namespace tf32x3 {

constexpr int kStages = 2;            // depth of the streamed-tile ring
constexpr int kRows = 128;            // the pinned tile: 8 warps of 16
constexpr int kThreads = 32 * (kRows / 16);

template <int DH>
struct Geo3 {
  // Dh 64: 64-row streamed tiles, split once a block; Dh 128: 32-row
  // streamed tiles, split at each fragment load
  static constexpr bool kPreSplit = DH == 64;
  static constexpr int kCols = DH == 64 ? 64 : 32;  // a streamed tile
  static constexpr int CT = kCols / 8;         // its 8-row tiles
  static constexpr int LD = DH + 4;            // padded shared-memory row
  static constexpr int kTile = kCols * LD;     // floats of a streamed tile
  // a stage: two tiles and, in dK/dV, their lse and delta values
  static constexpr int kStage = 2 * kTile + 2 * kCols;
  // the pinned tiles, the ring, the small planes of a stage's two tiles
  static constexpr int kBytes =
      (2 * kRows * LD + kStages * kStage + (kPreSplit ? 2 * kTile : 0)) * 4;
  // the forward: Q pinned and the ring (its tiles split at fragment load)
  static constexpr int kFwdBytes = (kRows * LD + kStages * kStage) * 4;
  static constexpr int NT = DH / 8;            // 8-column tiles of Dh
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + R - 1 of a row-major [n, DH] float32 matrix into dst
// (rows LD apart), 16 bytes a copy; rows past n are zero-filled.
template <int DH, int R>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int r0, int n) {
  using G = Geo3<DH>;
  constexpr int kChunks = DH / 4;  // 16-byte chunks a row
  static_assert(R * kChunks % kThreads == 0, "tile copies");
#pragma unroll
  for (int c = 0; c < R * kChunks / kThreads; ++c) {
    const int i = threadIdx.x + c * kThreads;
    const int r = i / kChunks, col = 4 * (i % kChunks);
    const bool live = r0 + r < n;
    cp_async16(dst + r * G::LD + col,
               src + (size_t)(live ? r0 + r : 0) * DH + col, live);
  }
}

// C lse values (threads 0 .. C - 1) and C delta values (C .. 2C - 1) of
// rows r0 ..; past n zeros.
template <int C>
__device__ __forceinline__ void stage_stats(float* dst, const float* lse,
                                            const float* delta, int r0,
                                            int n) {
  if (threadIdx.x >= 2 * C) return;
  const int r = threadIdx.x % C;
  const bool live = r0 + r < n;
  const float* src = threadIdx.x < C ? lse : delta;
  cp_async4(dst + (threadIdx.x < C ? 0 : C) + r,
            src + (live ? r0 + r : 0), live);
}

// x rounded to tf32 (10 stored mantissa bits), to nearest, ties away from
// zero, as `cvt.rna.tf32.f32` rounds a finite x: half of the dropped unit
// added to the magnitude's bits, the 13 low bits cleared (the value is
// exact as float32). Two integer instructions; `cvt.rna` compiles to
// four or five on sm_90a (it also tests for NaN and infinity).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Split a stage's two streamed tiles (2 x kCols rows, LD apart) in place:
// big over x, small into the plane `small` of the same layout.
template <int DH>
__device__ __forceinline__ void split_tiles(float* x, float* small) {
  using G = Geo3<DH>;
  constexpr int kChunks = DH / 4;
  static_assert(2 * G::kCols * kChunks % kThreads == 0, "tile split");
#pragma unroll
  for (int c = 0; c < 2 * G::kCols * kChunks / kThreads; ++c) {
    const int i = threadIdx.x + c * kThreads;
    const int o = (i / kChunks) * G::LD + 4 * (i % kChunks);
    const float4 v = *reinterpret_cast<const float4*>(x + o);
    uint4 b, s;
    split(v.x, b.x, s.x);
    split(v.y, b.y, s.y);
    split(v.z, b.z, s.z);
    split(v.w, b.w, s.w);
    *reinterpret_cast<uint4*>(x + o) = b;
    *reinterpret_cast<uint4*>(small + o) = s;
  }
}

// The B operand of a product: a streamed tile split once for the block
// into big and small planes (Dh 64), or the float32 tile, split here as
// each fragment element is loaded (Dh 128). `at(o)` is the element o
// floats from the operand's base.
struct BSplit {
  const float* big;
  const float* small;
  __device__ __forceinline__ void at(int o, uint32_t& b,
                                     uint32_t& s) const {
    b = __float_as_uint(big[o]);
    s = __float_as_uint(small[o]);
  }
  __device__ __forceinline__ BSplit operator+(int o) const {
    return {big + o, small + o};
  }
};
struct BRaw {
  const float* x;
  __device__ __forceinline__ void at(int o, uint32_t& b,
                                     uint32_t& s) const {
    split(x[o], b, s);
  }
  __device__ __forceinline__ BRaw operator+(int o) const { return {x + o}; }
};

// d += a b, m16n8k8, tf32 operands, float32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b from a zero accumulator
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// A float32 A fragment (a[0..3] at rows g, g + 8, g, g + 8 and columns
// t, t, t + 4, t + 4), split.
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split(a0, big[0], small[0]);
    split(a1, big[1], small[1]);
    split(a2, big[2], small[2]);
    split(a3, big[3], small[3]);
  }
};

// Sums. The tensor cores add a product's 8 terms and its accumulator
// aligned to the largest of them and truncated, so a long chain of
// products into one accumulator drifts: chained over a 64-key tile, the
// gradients lay 2.5-3.6 times design 1's error from a float64 backward,
// over the whole sweep 8-16 times (PERF.md). So a k-step's big * big
// product (its 8 terms) is taken from a zero accumulator and added to the
// float32 sum on the FMA units, rounded to nearest, as design 1 adds; the
// two small products (small * big, then big * small), about 2^-11 of it,
// are chained on the tensor cores in an accumulator of their own (its
// drift is 2^-11 smaller), added to the sum once a tile. The forward sums
// both its products so too.

// d += a b in 3xTF32: small * big and big * small into lo, in that
// order; big * big from zero, added to d. (bb0, bs0), (bb1, bs1): the B
// fragment's two elements (rows t and t + 4 of column g), split.
__device__ __forceinline__ void mma3(float (&d)[4], float (&lo)[4],
                                     const FragA& a, uint32_t bb0,
                                     uint32_t bs0, uint32_t bb1,
                                     uint32_t bs1) {
  mma(lo, a.small, bb0, bb1);
  mma(lo, a.big, bs0, bs1);
  float hi[4];
  mma0(hi, a.big, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += hi[e];
}

template <int N, int M>
__device__ __forceinline__ void zero(float (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) x[i][j] = 0.f;
}

// acc[n] = A B^T over the Dh columns: A the warp's 16 pinned rows (sA,
// rows LD apart), B the kCols rows of a streamed tile; acc[n] the m16n8
// accumulator of B's rows 8n .. 8n + 7. The k-steps are unrolled by
// kUnroll: by two in the backward (fully unrolled, its sweep's body
// outgrows the instruction cache: 2% slower at path_t's shape), fully in
// the forward (1-5% faster at its shapes in `tools/torch_b3a_variants.py`).
template <int DH, int kUnroll = 2, typename B>
__device__ __forceinline__ void rows_product(
    float (&acc)[Geo3<DH>::CT][4], const float* __restrict__ sA,
    const B& sB, int g, int t) {
  constexpr int LD = Geo3<DH>::LD, CT = Geo3<DH>::CT;
  float lo[CT][4];
  zero(acc);
  zero(lo);
#pragma unroll (kUnroll)
  for (int kk = 0; kk < DH / 8; ++kk) {
    const float* a = sA + g * LD + 8 * kk + t;
    const FragA fa(a[0], a[8 * LD], a[4], a[8 * LD + 4]);
    const B b = sB + (g * LD + 8 * kk + t);
#pragma unroll
    for (int n = 0; n < CT; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      b.at(8 * n * LD, bb0, bs0);
      b.at(8 * n * LD + 4, bb1, bs1);
      mma3(acc[n], lo[n], fa, bb0, bs0, bb1, bs1);
    }
  }
#pragma unroll
  for (int n = 0; n < CT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += lo[n][e];
}

// acc[n] += P B: P [16 x kCols] in the accumulator layout of rows_product
// (p[j] holds columns 8j + 2t, 8j + 2t + 1 of rows g, g + 8), B the kCols
// x Dh streamed tile; acc[n] the m16n8 accumulator of B's columns 8n ..
// 8n + 7. The reduction index of k-step j is permuted so that p[j] is the
// A fragment as it lies: A column t is B row 8j + 2t, A column t + 4 is B
// row 8j + 2t + 1. At Dh 128 the columns go in two halves of 64, so that
// the small products' accumulator stays 32 registers (P's split is taken
// again for the second).
template <int DH, typename B>
__device__ __forceinline__ void cols_product(
    float (&acc)[DH / 8][4], const float (&p)[Geo3<DH>::CT][4],
    const B& sB, int g, int t) {
  constexpr int LD = Geo3<DH>::LD;
#pragma unroll
  for (int c = 0; c < DH / 64; ++c) {
    float lo[8][4];
    zero(lo);
#pragma unroll
    for (int j = 0; j < Geo3<DH>::CT; ++j) {
      const FragA fa(p[j][0], p[j][2], p[j][1], p[j][3]);
      const B b = sB + ((8 * j + 2 * t) * LD + 64 * c + g);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        b.at(8 * n, bb0, bs0);
        b.at(LD + 8 * n, bb1, bs1);
        mma3(acc[8 * c + n], lo[n], fa, bb0, bs0, bb1, bs1);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[8 * c + n][e] += lo[n][e];
  }
}

// a warp's m16n8 accumulators (rows r, r + 8; columns 8n + 2t, + 1) into
// a row-major [n_rows, DH] float32 output; rows past n_rows skipped
template <int DH>
__device__ __forceinline__ void store_acc(float* __restrict__ out,
                                          const float (&acc)[DH / 8][4],
                                          int r, int n_rows, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(out + (size_t)(r + 8 * h) * DH + 8 * n +
                                 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// The B operands of a stage's two tiles (X at `stage`, Y after it): split
// planes at Dh 64, the raw tiles at Dh 128.
template <int DH>
struct StageB {
  using B = typename std::conditional<Geo3<DH>::kPreSplit, BSplit,
                                      BRaw>::type;
  B x, y;
  __device__ __forceinline__ StageB(const float* stage,
                                    const float* small) {
    if constexpr (Geo3<DH>::kPreSplit) {
      x = B{stage, small};
      y = B{stage + Geo3<DH>::kTile, small + Geo3<DH>::kTile};
    } else {
      x = B{stage};
      y = B{stage + Geo3<DH>::kTile};
    }
  }
};

// B3b, design 3. Block (bh, kb) owns kRows keys from k0 = kRows kb, K and
// V pinned; the Q and dO tiles (with their lse and delta) are streamed
// from the key tile's diagonal on (causal) or from the first.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_tf32x3_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int Tq, int Tk, float scale, int causal) {
  using G = Geo3<DH>;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kRows * G::LD;
  float* ring = sV + kRows * G::LD;
  float* small = ring + kStages * G::kStage;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + bh * Tq * DH;
  const float* ob = dout + bh * Tq * DH;
  constexpr int C = G::kCols;
  // causal: a Q tile above this key tile's first row sees none of it
  const int qt0 = causal ? k0 / C : 0;
  const int nt = (Tq + C - 1) / C - qt0;
  auto issue = [&](int i) {
    if (i < nt) {
      float* st = ring + (i % kStages) * G::kStage;
      const int q0 = (qt0 + i) * C;
      stage_tile<DH, C>(st, qb, q0, Tq);
      stage_tile<DH, C>(st + G::kTile, ob, q0, Tq);
      stage_stats<C>(st + 2 * G::kTile, lse + bh * Tq, delta + bh * Tq,
                     q0, Tq);
    }
    cp_async_commit();  // an empty group past the last tile
  };
  stage_tile<DH, kRows>(sK, k + bh * Tk * DH, k0, Tk);
  stage_tile<DH, kRows>(sV, v + bh * Tk * DH, k0, Tk);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float dka[G::NT][4], dva[G::NT][4];
  zero(dka);
  zero(dva);
  const float* wK = sK + 16 * warp * G::LD;
  const float* wV = sV + 16 * warp * G::LD;
  const int kr = k0 + 16 * warp + g;  // this lane's keys kr, kr + 8
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; tile i - 1's buffers are free
    issue(i + kStages - 1);
    float* st = ring + (i % kStages) * G::kStage;
    if constexpr (G::kPreSplit) {
      split_tiles<DH>(st, small);
      __syncthreads();
    }
    const StageB<DH> b(st, small);  // x: Q, y: dO
    const float* sL = st + 2 * G::kTile;
    const float* sD = sL + C;
    const int q0 = (qt0 + i) * C;
    // causal: a warp whose first key is past the tile's last query sees
    // none of it
    if (causal && q0 + C <= k0 + 16 * warp) continue;
    float s[G::CT][4], dp[G::CT][4];
    rows_product<DH>(s, wK, b.x, g, t);   // S^T = K Q^T
    rows_product<DH>(dp, wV, b.y, g, t);  // dP^T = V dO^T
    const bool edge =
        (causal && q0 < k0 + kRows) || q0 + C > Tq || k0 + kRows > Tk;
#pragma unroll
    for (int j = 0; j < G::CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lc = 8 * j + 2 * t + (e & 1);
        const int qc = q0 + lc, kc = kr + 8 * (e >> 1);
        const bool live =
            !edge || (kc < Tk && qc < Tq && (!causal || qc >= kc));
        const float p = live ? expf(s[j][e] * scale - sL[lc]) : 0.f;
        dp[j][e] = p * (dp[j][e] - sD[lc]) * scale;  // dS^T
        s[j][e] = p;                                 // P^T
      }
    cols_product<DH>(dva, s, b.y, g, t);   // dV += P^T dO
    cols_product<DH>(dka, dp, b.x, g, t);  // dK += dS^T Q
  }
  cp_async_wait<0>();
  store_acc<DH>(dk + bh * Tk * DH, dka, kr, Tk, t);
  store_acc<DH>(dv + bh * Tk * DH, dva, kr, Tk, t);
}

// B3c, design 3. Block (bh, qb) owns kRows queries from q0 = kRows qb, Q,
// dO and their lse and delta pinned; the K and V tiles are streamed up to
// the query tile's diagonal (causal) or to the end. Causal grids reverse
// qb, so the blocks that sweep the most key tiles start first.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq, int Tq, int Tk, float scale,
                     int causal) {
  using G = Geo3<DH>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + kRows * G::LD;
  float* ring = sO + kRows * G::LD;
  float* small = ring + kStages * G::kStage;
  const size_t bh = blockIdx.x;
  const int nqt = (Tq + kRows - 1) / kRows;
  const int qt = causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + bh * Tk * DH;
  const float* vb = v + bh * Tk * DH;
  constexpr int C = G::kCols;
  int nt = (Tk + C - 1) / C;
  if (causal) nt = min(nt, (q0 + kRows - 1) / C + 1);
  auto issue = [&](int i) {
    if (i < nt) {
      float* st = ring + (i % kStages) * G::kStage;
      stage_tile<DH, C>(st, kb, i * C, Tk);
      stage_tile<DH, C>(st + G::kTile, vb, i * C, Tk);
    }
    cp_async_commit();
  };
  stage_tile<DH, kRows>(sQ, q + bh * Tq * DH, q0, Tq);
  stage_tile<DH, kRows>(sO, dout + bh * Tq * DH, q0, Tq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const int qr = q0 + 16 * warp + g;  // this lane's queries qr, qr + 8
  float L[2], D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qr + 8 * h < Tq;
    L[h] = in ? lse[bh * Tq + qr + 8 * h] : 0.f;
    D[h] = in ? delta[bh * Tq + qr + 8 * h] : 0.f;
  }
  float dqa[G::NT][4];
  zero(dqa);
  const float* wQ = sQ + 16 * warp * G::LD;
  const float* wO = sO + 16 * warp * G::LD;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    float* st = ring + (i % kStages) * G::kStage;
    if constexpr (G::kPreSplit) {
      split_tiles<DH>(st, small);
      __syncthreads();
    }
    const StageB<DH> b(st, small);  // x: K, y: V
    const int k0 = i * C;
    // causal: a warp whose last query is before the tile's first key sees
    // none of it
    if (causal && k0 > q0 + 16 * warp + 15) continue;
    float s[G::CT][4], dp[G::CT][4];
    rows_product<DH>(s, wQ, b.x, g, t);   // S = Q K^T
    rows_product<DH>(dp, wO, b.y, g, t);  // dP = dO V^T
    const bool edge =
        (causal && k0 + C > q0) || k0 + C > Tk || q0 + kRows > Tq;
#pragma unroll
    for (int j = 0; j < G::CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + 8 * j + 2 * t + (e & 1);
        const int h = e >> 1, qc = qr + 8 * h;
        const bool live =
            !edge || (qc < Tq && kc < Tk && (!causal || kc <= qc));
        const float p = live ? expf(s[j][e] * scale - L[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - D[h]) * scale;  // dS
      }
    cols_product<DH>(dqa, s, b.x, g, t);  // dQ += dS K
  }
  cp_async_wait<0>();
  store_acc<DH>(dq + bh * Tq * DH, dqa, qr, Tq, t);
}

// B3a, design 3. Block (bh, qb) owns kRows queries from q0 = kRows qb, Q
// pinned; the K and V tiles are streamed up to the query tile's diagonal
// (causal) or to the end, as in B3c, every operand split as its fragments
// are loaded (one barrier a tile). Per tile a warp computes S = Q K^T
// for its 16 rows, then the online softmax in registers: a row's scores
// lie in one quad (lane (g, t) holds rows g and g + 8), so its tile max
// is two shuffles; m_new = max(m, tile max), alpha = exp(m - m_new), p =
// exp(s scale - m_new), the lane's share of l = l alpha + sum p (the
// quad's shares are summed once, at the end); the O accumulators are
// scaled by alpha and O += P V takes P from the accumulators as the A
// fragment (`cols_product`'s permuted reduction index). Keys past Tk get
// p = 0 and stay out of the max; causal-masked scores are -1e30, as in
// design 1. Causal grids reverse qb, so the blocks that sweep the most
// key tiles start first. o = acc / l (a division) and lse = m + log(l),
// l clamped at 1e-30.
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int Tq, int Tk, float scale,
                  int causal) {
  using G = Geo3<DH>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* ring = sQ + kRows * G::LD;
  const size_t bh = blockIdx.x;
  const int nqt = (Tq + kRows - 1) / kRows;
  const int qt = causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + bh * Tk * DH;
  const float* vb = v + bh * Tk * DH;
  constexpr int C = G::kCols;
  int nt = (Tk + C - 1) / C;
  if (causal) nt = min(nt, (q0 + kRows - 1) / C + 1);
  auto issue = [&](int i) {
    if (i < nt) {
      float* st = ring + (i % kStages) * G::kStage;
      stage_tile<DH, C>(st, kb, i * C, Tk);
      stage_tile<DH, C>(st + G::kTile, vb, i * C, Tk);
    }
    cp_async_commit();
  };
  stage_tile<DH, kRows>(sQ, q + bh * Tq * DH, q0, Tq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const int qr = q0 + 16 * warp + g;  // this lane's queries qr, qr + 8
  const float* wQ = sQ + 16 * warp * G::LD;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float oa[G::NT][4];
  zero(oa);
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i (and, at i 0, Q) landed; i - 1's are free
    issue(i + kStages - 1);
    const float* st = ring + (i % kStages) * G::kStage;
    const BRaw bk{st}, bv{st + G::kTile};
    const int k0 = i * C;
    // causal: a warp whose last query is before the tile's first key sees
    // none of it
    if (causal && k0 > q0 + 16 * warp + 15) continue;
    float s[G::CT][4];
    rows_product<DH, DH / 8>(s, wQ, bk, g, t);  // S = Q K^T
    const bool edge =
        (causal && k0 + C - 1 > q0 + 16 * warp) || k0 + C > Tk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < G::CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[j][e] * scale;
        if (edge) {
          const int kc = k0 + 8 * j + 2 * t + (e & 1);
          if (kc >= Tk)
            x = -__int_as_float(0x7f800000);  // -inf: p 0, not in the max
          else if (causal && kc > qr + 8 * h)
            x = kNegInf;
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < G::CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;  // P
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < G::NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oa[n][e] *= alpha[e >> 1];
    cols_product<DH>(oa, s, bv, g, t);  // O += P V
  }
  cp_async_wait<0>();
  float li[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    li[h] = fmaxf(l[h], 1e-30f);
  }
  // o = acc / l, divided as the TPU kernel divides (not times 1 / l)
#pragma unroll
  for (int n = 0; n < G::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oa[n][e] = oa[n][e] / li[e >> 1];
  store_acc<DH>(o + bh * Tq * DH, oa, qr, Tq, t);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qr + 8 * h < Tq) lse[bh * Tq + qr + 8 * h] = m[h] + logf(li[h]);
  }
}

template <int DH>
int launch(Which w, const Args& a, cudaStream_t st) {
  using G = Geo3<DH>;
  constexpr int smem = G::kBytes;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* o = static_cast<const float*>(a.dout);
  if (w == kFwd) {
    static const cudaError_t once = cudaFuncSetAttribute(
        fwd_tf32x3_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::kFwdBytes);
    if (once != cudaSuccess) return (int)once;
    fwd_tf32x3_kernel<DH><<<dim3(a.BH, (a.Tq + kRows - 1) / kRows),
                            kThreads, G::kFwdBytes, st>>>(
        q, k, v, static_cast<float*>(a.o), a.lse, a.Tq, a.Tk, a.scale,
        a.causal);
  } else if (w == kDkdv) {
    static const cudaError_t once = cudaFuncSetAttribute(
        bwd_dkdv_tf32x3_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (once != cudaSuccess) return (int)once;
    bwd_dkdv_tf32x3_kernel<DH>
        <<<dim3(a.BH, (a.Tk + kRows - 1) / kRows), kThreads, smem,
           st>>>(q, k, v, o, a.lse, a.delta, static_cast<float*>(a.dk),
                 static_cast<float*>(a.dv), a.Tq, a.Tk, a.scale, a.causal);
  } else {
    static const cudaError_t once = cudaFuncSetAttribute(
        bwd_dq_tf32x3_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (once != cudaSuccess) return (int)once;
    bwd_dq_tf32x3_kernel<DH>
        <<<dim3(a.BH, (a.Tq + kRows - 1) / kRows), kThreads, smem,
           st>>>(q, k, v, o, a.lse, a.delta, static_cast<float*>(a.dq),
                 a.Tq, a.Tk, a.scale, a.causal);
  }
  return (int)cudaGetLastError();
}

int run(Which w, const Args& a, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.dout);
  if ((a.Dh != 64 && a.Dh != 128) || (ptrs & 15) ||
      a.Tq < 0 || a.Tk < 1 || a.BH < 0 || (a.causal && a.Tq != a.Tk) ||
      (a.Tq + kRows - 1) / kRows > 65535 ||
      (a.Tk + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.BH == 0 || a.Tq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.Dh == 64 ? launch<64>(w, a, st) : launch<128>(w, a, st);
}

}  // namespace tf32x3

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients
// share it; lse and delta are float32). lse may be null (no training
// residual). Returns 0 or a cudaError_t code.
int dl4j_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int Tq, int Tk, int Dh, float scale,
                   int causal, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return run(kFwd, a, dtype, stream);
}

// Design 2 of B3a, bfloat16 on the tensor cores: q, k, v bfloat16 [BH, T,
// Dh] with Dh 64 or 128 and 16-byte aligned data; o bfloat16; lse float32
// [BH, Tq] or null. Returns 0 or a cudaError_t.
int dl4j_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int BH, int Tq, int Tk, int Dh,
                         float scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return tc::run(kFwd, a, stream);
}

int dl4j_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int BH,
                        int Tq, int Tk, int Dh, float scale, int causal,
                        int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = const_cast<float*>(lse);
  a.delta = delta; a.dk = dk; a.dv = dv;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return run(kDkdv, a, dtype, stream);
}

int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int BH, int Tq, int Tk, int Dh, float scale,
                      int causal, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = const_cast<float*>(lse);
  a.delta = delta; a.dq = dq;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return run(kDq, a, dtype, stream);
}

// Design 2 of B3b and B3c, bfloat16 on the tensor cores: q, k, v, dout
// bfloat16 [BH, T, Dh] with Dh 64 or 128 and 16-byte aligned data; lse and
// delta float32 [BH, Tq]; dk, dv, dq bfloat16. Returns 0 or a cudaError_t.
int dl4j_flash_bwd_dkdv_wgmma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv,
                              int BH, int Tq, int Tk, int Dh, float scale,
                              int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = const_cast<float*>(lse);
  a.delta = delta; a.dk = dk; a.dv = dv;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return tc::run(kDkdv, a, stream);
}

int dl4j_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int BH, int Tq,
                            int Tk, int Dh, float scale, int causal,
                            void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = const_cast<float*>(lse);
  a.delta = delta; a.dq = dq;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return tc::run(kDq, a, stream);
}

// Design 3 of B3a, float32 on the tensor cores as 3xTF32: q, k, v float32
// [BH, T, Dh] with Dh 64 or 128 and 16-byte aligned data; o float32; lse
// float32 [BH, Tq] or null. Returns 0 or a cudaError_t.
int dl4j_flash_fwd_tf32x3(const void* q, const void* k, const void* v,
                          void* o, float* lse, int BH, int Tq, int Tk,
                          int Dh, float scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return tf32x3::run(kFwd, a, stream);
}

// Design 3 of B3b and B3c, float32 on the tensor cores as 3xTF32: q, k, v,
// dout float32 [BH, T, Dh] with Dh 64 or 128 and 16-byte aligned data; lse
// and delta float32 [BH, Tq]; dk, dv, dq float32. Returns 0 or a
// cudaError_t.
int dl4j_flash_bwd_dkdv_tf32x3(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv,
                               int BH, int Tq, int Tk, int Dh, float scale,
                               int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = const_cast<float*>(lse);
  a.delta = delta; a.dk = dk; a.dv = dv;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return tf32x3::run(kDkdv, a, stream);
}

int dl4j_flash_bwd_dq_tf32x3(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, int BH, int Tq,
                             int Tk, int Dh, float scale, int causal,
                             void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = const_cast<float*>(lse);
  a.delta = delta; a.dq = dq;
  a.BH = BH; a.Tq = Tq; a.Tk = Tk; a.Dh = Dh; a.scale = scale;
  a.causal = causal;
  return tf32x3::run(kDq, a, stream);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
