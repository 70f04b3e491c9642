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
// Not done yet: folding the G heads of a group into one block's rows (the
// TPU kernel's [G x Bq, Dh] query tile, so that K/V are staged once a
// group), tensor cores, TMA and a pipelined K/V ring — later work.
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

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
