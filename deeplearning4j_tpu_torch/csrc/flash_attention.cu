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
// The backward rematerializes each score tile from the saved lse, as the
// TPU kernels do (`_bwd_tile`): p = exp(s - L), ds = p * (dp - delta) *
// scale, with delta = rowsum(dO * O) computed by the caller in f32. The
// two-kernel split needs no atomics, so the backward is deterministic.
//
// Bound. Attention is matrix products over the visible (query, key) pairs:
// 2 products forward and 5 backward (S, dP, dV, dK, dQ), 2 Dh flops a pair
// each. At T 2048 and Dh 64 that is about 64 flops a byte moved, so the
// kernels are bound by the arithmetic rate, not by memory.
//
// Design. Exact float32 arithmetic on the FMA units (no tensor cores and
// no TF32: the port's float32 path is exact float32); bfloat16 inputs are
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
// a compile-time tile DM in {32, 64, 128}; the smallest that holds Dh is launched and columns past
// Dh are zeros. Any Tq and Tk work: rows and keys past the end are staged
// as zeros and masked out of the softmax (p = 0). A causal block stops at
// its last row's tile (the forward and dQ kernels) or starts at its first
// row's (dK/dV). Shared memory is 45-170 KB, above the 48 KB static limit,
// so each instantiation raises its dynamic limit once.
// Not done yet: tensor cores (wgmma in bf16, TF32 if allowed), TMA and a
// pipelined K/V ring — later work.
//
// Numerics. As the TPU kernels: the causal mask value is -1e30, the
// running max starts at -1e30, l is clamped at 1e-30 before the division
// and the log. Build without --use_fast_math so expf, logf and the
// division stay IEEE.

#include "attention_tiles.cuh"

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
        const float p = kj < Tk ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * 4 + i) * kLDP + tx + 16 * j] = p;
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
        sPt[(ty * 4 + i) * kLDP + lc] = p;
        sSt[(ty * 4 + i) * kLDP + lc] = p * (dpt[i][j] - sD[lc]) * scale;
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
        sS[li * kLDP + tx + 16 * j] = p * (dp[i][j] - sD[li]) * scale;
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

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
