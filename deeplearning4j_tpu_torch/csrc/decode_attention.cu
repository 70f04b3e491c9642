// Single-query decode attention over the serving KV pool, for Hopper
// (sm_90a). Two kernels share one online-softmax routine:
//
//   decode_attention_kernel        — replaces the TPU kernel B5,
//     deeplearning4j_tpu/ops/banded_attention.py `_decode_kernel` (via
//     `banded_decode_attention`): slot pool caches [S, L, Hkv, Dh], linear
//     visibility with an optional window, or a rolling ring whose slot j
//     holds global position held = end - ((end - j) mod L).
//   paged_decode_attention_kernel  — replaces the TPU kernel B6,
//     `_paged_decode_kernel` (via `paged_decode_attention`): physical page
//     pools [P, Lp, Hkv, Dh] addressed through page_table[S, NP], linear
//     visibility over logical positions.
//
// Both are templated on the cache's element type: the query's float32 or
// bfloat16, or quantized codes (int8, or e4m3) — the TPU bodies'
// `quant=True` branch (B5q, B6q): each K/V element is widened to float32
// and multiplied by its (token, kv head) scale right after the load, from
// float32 scale rows [S, L, Hkv] (slot pool) or [P, Lp, Hkv] (pages) that
// sit beside the caches and are addressed by the same row index.
//
// Bound. The work is 4 * G * Dh flops per visible key against 2 * Dh
// stored K/V elements, far below the card's compute rate: the kernels are
// bound by the bytes of the visible keys' K and V rows (plus, quantized,
// their two 4-byte scales), read once, over the card's 3.35 TB/s.
//
// Design. One block per (slot, KV head) holds the G = H / Hkv query rows
// of its group in registers. The visible keys of a slot are one
// contiguous range of logical positions [lo, hi], which the block reads
// from its own qpos[s], end[s] and page-table entries in device memory
// (positions never go to the host):
//   linear:  lo = max(0, qpos - w + 1),             hi = min(qpos, L - 1)
//   ring:    lo = max(0, qpos - w + 1, end - L + 1), hi = min(qpos, end)
// On the ring each position p in (end - L, end] is held by exactly one
// slot, p mod L, so the range is exactly the set the TPU kernel selects
// with `held` over all L slots; here no dead tile or dead key is ever
// read (the TPU kernel's `relevant` rule skips dead tiles on a linear
// cache and none on a ring). Ragged cache lengths and any page length
// need nothing special: the range ends where it ends. The block's 8
// warps take groups of U keys in turn; each lane reads its pairs of
// neighbouring elements (d = 64 e + 2 lane and d + 1) of every K and V
// row straight into registers, one 8-byte (float32), 4-byte (bfloat16) or
// 2-byte (int8, e4m3) load a pair, neighbouring lanes on neighbouring
// addresses, and a quantized key's two scales as one broadcast load each
// beside its K/V pairs; a warp
// issues its next group's loads before it folds the current group, so
// load latency overlaps the arithmetic; and each warp folds its keys
// into its own
// running (max, sum, accumulator) online softmax, in f32 whatever the
// storage type. The warps merge once, through shared
// memory, at the end. The register tiles are compile-time: GM >= G query
// rows and EM >= Dh / 32 elements a lane (Dh even), launched from GM in
// {1, 2, 4, 8} and EM in {2, 4}. Each K/V byte is read by one block; a
// GQA group shares one sweep; nothing is gathered or broadcast to H
// heads.
// Not done yet: splitting L across blocks (S * Hkv blocks leave most of
// the 132 SMs idle at small batch), 4- or 8-code loads a lane for the
// 1-byte caches, wgmma and TMA — later work.
//
// Numerics. The running max starts at -1e30, not -inf. A key past the
// range contributes nothing (the `u < n` guard plays the part of the TPU
// kernel's dead-block guard p = where(vis, exp(s - m), 0)), and a row
// with no visible key comes out as zeros (l = max(l, 1e-30)). A NaN
// query (the layers' overflow poison) comes out NaN: fmaxf drops a NaN
// score from the max, but exp(s - m) carries it into the sums. Positions
// are mapped to ring slots only from p >= 0, with a floor modulo all the
// same (CUDA's % truncates toward zero). Build without --use_fast_math
// so expf and the NaN path stay exact.
// bfloat16 caches: p meets V rounded to bfloat16, as the TPU bodies'
// `p.astype(vc.dtype)` feeds it (C6), against the row max. The TPU
// kernels round against the running max of their cache blocks; here the
// warps' running maxima differ, so a bfloat16 block first sweeps the K
// rows of its range for the row max (K is read twice), the warps share
// it through shared memory, and the second sweep starts every warp from
// it. l sums the unrounded p. Quantized codes are widened to float32
// (as the TPU bodies widen them) and float32 caches never round.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// largest register tiles; ops/banded_attention.py (MAX_GROUP,
// MAX_HEAD_DIM) checks the same limits before it launches
constexpr int kMaxG = 8;       // query rows per KV head (H / Hkv)
constexpr int kMaxE = 4;       // head-dim elements per lane: Dh <= 128
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int floor_mod(int a, int n) {
  return ((a % n) + n) % n;
}

// a lane's two neighbouring head-dim elements d and d + 1, as floats, from
// one 8-byte (float32) or 4-byte (bfloat16) load
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}
__device__ __forceinline__ float2 load_pair(const __nv_fp8_e4m3* p) {
  // e4m3 -> half is exact; the lower address is .x
  const __nv_fp8x2_storage_t raw =
      *reinterpret_cast<const __nv_fp8x2_storage_t*>(p);
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(raw, __NV_E4M3)));
}

// quantized cache codes carry float32 scale rows
template <typename TC>
struct Quant { static constexpr bool value = false; };
template <>
struct Quant<int8_t> { static constexpr bool value = true; };
template <>
struct Quant<__nv_fp8_e4m3> { static constexpr bool value = true; };

// bfloat16 caches round p where it meets V (C6)
template <typename TC>
struct RoundsP { static constexpr bool value = false; };
template <>
struct RoundsP<__nv_bfloat16> { static constexpr bool value = true; };

// GM query rows and EM head-dim elements a lane (PM = EM / 2 pairs, pair e
// holding d = 64 e + 2 lane and d + 1); a warp folds U keys a step, fewer
// as the tile grows, so two groups' K/V fit in registers at once
template <int GM, int EM>
struct Tile {
  static constexpr int PM = EM / 2;
  static constexpr int U = GM * EM <= 2 ? 8 : (GM * EM <= 8 ? 4 : 2);
};

// The K and V rows of one group of U keys, as this lane's pairs.
template <int U, int PM>
struct KVGroup {
  float2 k[U][PM];
  float2 v[U][PM];
};

// Issue the loads of the n <= U keys at logical positions p0, p0 + 1, ...
// (keys past n and elements past Dh read nothing and hold zeros). row(p)
// is the index of position p's [Dh] row for this KV head, in units of
// rows: its elements start at row(p) * Dh, its scales at sk/sv[row(p)].
// Quantized codes are multiplied by their scale right after the load.
// kV false loads the K rows alone.
template <typename TC, int U, int PM, bool kV = true, typename Row>
__device__ __forceinline__ void load_group(const TC* __restrict__ kc,
                                           const TC* __restrict__ vc,
                                           const float* __restrict__ sk,
                                           const float* __restrict__ sv,
                                           int p0, int n, int Dh, Row row,
                                           KVGroup<U, PM>& r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool live = u < n;
    const size_t ri = live ? row(p0 + u) : 0;
    const size_t off = ri * Dh;
    float fk = 1.f, fv = 1.f;
    if (Quant<TC>::value && live) {
      fk = sk[ri];
      if (kV) fv = sv[ri];
    }
#pragma unroll
    for (int e = 0; e < PM; ++e) {
      const int d = 64 * e + 2 * lane;
      const bool ok = live && d < Dh;
      float2 k2 = ok ? load_pair(kc + off + d) : make_float2(0.f, 0.f);
      float2 v2 = kV && ok ? load_pair(vc + off + d)
                           : make_float2(0.f, 0.f);
      if (Quant<TC>::value) {
        k2.x *= fk; k2.y *= fk;
        v2.x *= fv; v2.y *= fv;
      }
      r.k[u][e] = k2;
      r.v[u][e] = v2;
    }
  }
}

// One warp's online-softmax state over the keys it has folded: running
// max m[g] and sum l[g] per query row, and this lane's pairs acc[g][e] of
// the accumulator.
template <int GM, int PM>
struct WarpState {
  float m[GM];
  float l[GM];
  float2 acc[GM][PM];
};

// One query row's scaled score against one key row, summed over the warp.
template <int PM>
__device__ __forceinline__ float score(const float2 (&q)[PM],
                                       const float2 (&k)[PM], float scale) {
  float part = 0.f;
#pragma unroll
  for (int e = 0; e < PM; ++e) {
    part = fmaf(q[e].x, k[e].x, part);
    part = fmaf(q[e].y, k[e].y, part);
  }
  return warp_sum(part) * scale;
}

// The first sweep of a rounding (bfloat16) block: fold the first n keys'
// scores of a loaded group into the warp's running max alone.
template <int GM, int U, int PM>
__device__ __forceinline__ void max_keys(const KVGroup<U, PM>& r, int n,
                                         const float2 (&q)[GM][PM], int G,
                                         float scale, float (&m)[GM]) {
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float s = score(q[g], r.k[u], scale);
        if (u < n) m[g] = fmaxf(m[g], s);
      }
    }
  }
}

// The online-softmax step both kernels share: fold the first n keys of a
// loaded group into the warp's state; kRound feeds p to P·V rounded to
// bfloat16 (C6).
template <bool kRound, int GM, int U, int PM>
__device__ __forceinline__ void attend_keys(const KVGroup<U, PM>& r, int n,
                                            const float2 (&q)[GM][PM],
                                            int G, float scale,
                                            WarpState<GM, PM>& st) {
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      float s[U];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = score(q[g], r.k[u], scale);
        if (u < n) mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(st.m[g], mx);
      const float alpha = expf(st.m[g] - m_new);
      float l = st.l[g] * alpha;
      float2 a[PM];
#pragma unroll
      for (int e = 0; e < PM; ++e) {
        a[e].x = st.acc[g][e].x * alpha;
        a[e].y = st.acc[g][e].y * alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < n) {
          const float p = expf(s[u] - m_new);
          l += p;
          const float pv =
              kRound ? __bfloat162float(__float2bfloat16(p)) : p;
#pragma unroll
          for (int e = 0; e < PM; ++e) {
            a[e].x = fmaf(pv, r.v[u][e].x, a[e].x);
            a[e].y = fmaf(pv, r.v[u][e].y, a[e].y);
          }
        }
      }
      st.m[g] = m_new;
      st.l[g] = l;
#pragma unroll
      for (int e = 0; e < PM; ++e) st.acc[g][e] = a[e];
    }
  }
}

// One warp's sweep over the keys [lo, hi]: the warps take groups of U
// keys in turn, and each issues its next group's loads before it folds
// the current one, fold(group, n).
template <typename TC, int U, int PM, bool kV, typename Row, typename Fold>
__device__ __forceinline__ void sweep(const TC* __restrict__ kc,
                                      const TC* __restrict__ vc,
                                      const float* __restrict__ sk,
                                      const float* __restrict__ sv, int lo,
                                      int hi, int Dh, Row row, Fold fold) {
  const int warp = threadIdx.x >> 5;
  int p0 = lo + warp * U;
  int n = p0 <= hi ? min(U, hi - p0 + 1) : 0;
  KVGroup<U, PM> cur, nxt;
  load_group<TC, U, PM, kV>(kc, vc, sk, sv, p0, n, Dh, row, cur);
  while (n > 0) {
    const int p1 = p0 + kWarps * U;
    const int n1 = p1 <= hi ? min(U, hi - p1 + 1) : 0;
    load_group<TC, U, PM, kV>(kc, vc, sk, sv, p1, n1, Dh, row, nxt);
    fold(cur, n);
    cur = nxt;
    p0 = p1;
    n = n1;
  }
}

// The block of (slot blockIdx.x, KV head blockIdx.y): attend its G query
// rows over the visible logical positions [lo, hi]; row(p) is the row
// index of position p's [Dh] row for this KV head (see load_group). The
// two kernels differ only in the range and in row.
template <typename TQ, typename TC, int GM, int EM, typename Row>
__device__ void decode_block(const TQ* __restrict__ q,
                             const TC* __restrict__ kc,
                             const TC* __restrict__ vc,
                             const float* __restrict__ sk,
                             const float* __restrict__ sv,
                             TQ* __restrict__ out, int H, int Hkv, int Dh,
                             float scale, int lo, int hi, Row row) {
  constexpr int U = Tile<GM, EM>::U;
  constexpr int PM = Tile<GM, EM>::PM;
  __shared__ float red_m[kWarps][GM];
  __shared__ float red_l[kWarps][GM];
  __shared__ float red_acc[kWarps][GM][32 * EM];
  const int s_ = blockIdx.x, hk = blockIdx.y;
  const int G = H / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = ((size_t)s_ * H + (size_t)hk * G) * Dh;

  float2 qr[GM][PM];
  WarpState<GM, PM> st;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    st.m[g] = kNegInf;
    st.l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PM; ++e) {
      const int d = 64 * e + 2 * lane;
      const bool ok = g < G && d < Dh;
      qr[g][e] = ok ? make_float2(to_f32(q[row0 + g * Dh + d]),
                                  to_f32(q[row0 + g * Dh + d + 1]))
                    : make_float2(0.f, 0.f);
      st.acc[g][e] = make_float2(0.f, 0.f);
    }
  }
  constexpr bool kRound = RoundsP<TC>::value;
  if constexpr (kRound) {
    // the row max first, shared by the warps, so that every warp rounds
    // p against it (C6)
    sweep<TC, U, PM, false>(kc, vc, sk, sv, lo, hi, Dh, row,
                            [&](const KVGroup<U, PM>& r, int n) {
                              max_keys<GM, U, PM>(r, n, qr, G, scale, st.m);
                            });
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (lane == 0) red_m[warp][g] = st.m[g];
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g)
      for (int w = 0; w < kWarps; ++w) st.m[g] = fmaxf(st.m[g], red_m[w][g]);
    __syncthreads();   // red_m is written again at the merge
  }
  sweep<TC, U, PM, true>(kc, vc, sk, sv, lo, hi, Dh, row,
                         [&](const KVGroup<U, PM>& r, int n) {
                           attend_keys<kRound, GM, U, PM>(r, n, qr, G, scale,
                                                          st);
                         });

  // merge the warps' partial softmaxes
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      red_m[warp][g] = st.m[g];
      red_l[warp][g] = st.l[g];
    }
#pragma unroll
    for (int e = 0; e < PM; ++e) {
      red_acc[warp][g][64 * e + 2 * lane] = st.acc[g][e].x;
      red_acc[warp][g][64 * e + 2 * lane + 1] = st.acc[g][e].y;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Dh; i += kThreads) {
    const int g = i / Dh, d = i % Dh;
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w][g]);
    float l = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(red_m[w][g] - m);
      l = fmaf(red_l[w][g], c, l);
      o = fmaf(red_acc[w][g][d], c, o);
    }
    from_f32(o / fmaxf(l, 1e-30f), out + row0 + i);
  }
}

template <typename TQ, typename TC, int GM, int EM>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                        const TC* __restrict__ vc,
                        const float* __restrict__ sk,
                        const float* __restrict__ sv, TQ* __restrict__ out,
                        const int* __restrict__ qpos,
                        const int* __restrict__ endp, int L, int H,
                        int Hkv, int Dh, int window, int rolling,
                        float scale) {
  const int s_ = blockIdx.x, hk = blockIdx.y;
  const int pos = qpos[s_];
  const size_t slot_base = (size_t)s_ * L;
  int lo = window > 0 ? max(0, pos - window + 1) : 0;
  int hi = min(pos, L - 1);
  if (rolling) {
    const int end = endp[s_];
    lo = max(lo, end - L + 1);
    hi = min(pos, end);
  }
  decode_block<TQ, TC, GM, EM>(
      q, kc, vc, sk, sv, out, H, Hkv, Dh, scale, lo, hi,
      [=](int p) -> size_t {
        const int j = rolling ? floor_mod(p, L) : p;
        return (slot_base + j) * Hkv + hk;
      });
}

template <typename TQ, typename TC, int GM, int EM>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const TQ* __restrict__ q,
                              const TC* __restrict__ kc,
                              const TC* __restrict__ vc,
                              const float* __restrict__ sk,
                              const float* __restrict__ sv,
                              TQ* __restrict__ out,
                              const int* __restrict__ page_table,
                              const int* __restrict__ qpos, int NP, int Lp,
                              int H, int Hkv, int Dh, int window,
                              float scale) {
  const int s_ = blockIdx.x, hk = blockIdx.y;
  const int pos = qpos[s_];
  const int* pt = page_table + (size_t)s_ * NP;
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int hi = min(pos, NP * Lp - 1);
  // logical position p lives at physical row pt[p / Lp], offset p % Lp;
  // the range never reaches an unmapped table entry (those hold page 0)
  decode_block<TQ, TC, GM, EM>(
      q, kc, vc, sk, sv, out, H, Hkv, Dh, scale, lo, hi,
      [=](int p) -> size_t {
        const size_t r = (size_t)pt[p / Lp] * Lp + (p % Lp);
        return r * Hkv + hk;
      });
}

struct SlotArgs {
  const void *q, *k, *v;
  const float *sk, *sv;
  void* out;
  const int *qpos, *end;
  int S, L, H, Hkv, Dh, window, rolling;
  float scale;
};

struct PagedArgs {
  const void *q, *k, *v;
  const float *sk, *sv;
  void* out;
  const int *page_table, *qpos;
  int S, NP, Lp, H, Hkv, Dh, window;
  float scale;
};

template <typename TQ, typename TC, int GM, int EM>
void launch(const SlotArgs& a, cudaStream_t st) {
  decode_attention_kernel<TQ, TC, GM, EM>
      <<<dim3(a.S, a.Hkv), kThreads, 0, st>>>(
          static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k),
          static_cast<const TC*>(a.v), a.sk, a.sv, static_cast<TQ*>(a.out),
          a.qpos, a.end, a.L, a.H, a.Hkv, a.Dh, a.window, a.rolling,
          a.scale);
}

template <typename TQ, typename TC, int GM, int EM>
void launch(const PagedArgs& a, cudaStream_t st) {
  paged_decode_attention_kernel<TQ, TC, GM, EM>
      <<<dim3(a.S, a.Hkv), kThreads, 0, st>>>(
          static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k),
          static_cast<const TC*>(a.v), a.sk, a.sv, static_cast<TQ*>(a.out),
          a.page_table, a.qpos, a.NP, a.Lp, a.H, a.Hkv, a.Dh, a.window,
          a.scale);
}

// the smallest register tile that holds the shape
template <typename TQ, typename TC, typename Args>
void launch_tiled(const Args& a, cudaStream_t st) {
  const int G = a.H / a.Hkv;
  const bool wide = a.Dh > 64;
  if (G <= 1) {
    wide ? launch<TQ, TC, 1, 4>(a, st) : launch<TQ, TC, 1, 2>(a, st);
  } else if (G <= 2) {
    wide ? launch<TQ, TC, 2, 4>(a, st) : launch<TQ, TC, 2, 2>(a, st);
  } else if (G <= 4) {
    wide ? launch<TQ, TC, 4, 4>(a, st) : launch<TQ, TC, 4, 2>(a, st);
  } else {
    wide ? launch<TQ, TC, 8, 4>(a, st) : launch<TQ, TC, 8, 2>(a, st);
  }
}

// cache_dtype: the query's own (native), 2 = int8 or 3 = e4m3 codes with
// scale rows
template <typename TQ, typename Args>
int launch_cache(const Args& a, int dtype, int cache_dtype,
                 cudaStream_t st) {
  if (cache_dtype == dtype) {
    launch_tiled<TQ, TQ>(a, st);
  } else if (cache_dtype == 2 && a.sk && a.sv) {
    launch_tiled<TQ, int8_t>(a, st);
  } else if (cache_dtype == 3 && a.sk && a.sv) {
    launch_tiled<TQ, __nv_fp8_e4m3>(a, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename Args>
int run(const Args& a, int dtype, int cache_dtype, void* stream) {
  if (a.Hkv < 1 || a.H % a.Hkv != 0 || a.H / a.Hkv > kMaxG || a.Dh < 2 ||
      a.Dh % 2 != 0 || a.Dh > 32 * kMaxE)
    return (int)cudaErrorInvalidValue;
  if (a.S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch_cache<float>(a, dtype, cache_dtype, st);
  } else if (dtype == 1) {
    rc = launch_cache<__nv_bfloat16>(a, dtype, cache_dtype, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (q and out): 0 = float32, 1 = bfloat16. cache_dtype: dtype for a
// native cache, 2 = int8 or 3 = e4m3 codes with float32 scale rows
// scale_k/scale_v (null for a native cache). Returns 0 or a cudaError_t
// code.
int dl4j_decode_attention(const void* q, const void* k, const void* v,
                          const float* scale_k, const float* scale_v,
                          void* out, const int* qpos, const int* end, int S,
                          int L, int H, int Hkv, int Dh, int window,
                          int rolling, float scale, int dtype,
                          int cache_dtype, void* stream) {
  const SlotArgs a{q, k, v, scale_k, scale_v, out, qpos, end, S, L, H,
                   Hkv, Dh, window, rolling, scale};
  return run(a, dtype, cache_dtype, stream);
}

int dl4j_paged_decode_attention(const void* q, const void* k, const void* v,
                                const float* scale_k, const float* scale_v,
                                void* out, const int* page_table,
                                const int* qpos, int S, int NP, int Lp,
                                int H, int Hkv, int Dh, int window,
                                float scale, int dtype, int cache_dtype,
                                void* stream) {
  const PagedArgs a{q, k, v, scale_k, scale_v, out, page_table, qpos, S,
                    NP, Lp, H, Hkv, Dh, window, scale};
  return run(a, dtype, cache_dtype, stream);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
