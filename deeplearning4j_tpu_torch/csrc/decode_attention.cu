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
// Design 1 leaves most of the 132 SMs idle at small batch (S * Hkv
// blocks, one slot's whole range through one SM) and loads 2-8 bytes a
// lane behind a dependent page-table read a key. B6/B6q and B5/B5q have a
// second design for float32 queries (`split`, below the design-1
// kernels): the key range split over many blocks, keys streamed through
// shared memory 16 bytes a thread, one merge in fixed order. bfloat16
// caches stay on design 1.
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

// ===========================================================================
// Design 2 of B6 and B6q, and of B5 and B5q: float32 queries over float32,
// int8 or e4m3 caches, Dh 64 or 128, G <= 8 (`b6_design` and `b5_design` in
// ops/banded_attention.py).
//
// Grid (S, Hkv, NSPLIT). B6: block (s, hk, z) owns the C logical pages
// [zC, zC + C) of slot s's table (NSPLIT = ceil(NP / C); the host picks C
// from the shapes alone, `b6_splits`, so that the grid holds at least two
// blocks an SM where the table allows) and the part of the visible range
// [lo, hi] that lies in them; positions stay on the device. B5: the slot's
// logical positions split in chunks of C aligned to multiples of C, and
// block (s, hk, z) owns chunk lo / C + z, so a windowed cache needs only
// NSPLIT = ceil(min(w, L) / C) + 1 blocks a slot and KV head, a linear one
// ceil(L / C) (`b5_splits`); position p lives in ring slot p mod L, so a
// chunk may wrap the ring once. A B6 block
// reads its page-table entries once into shared memory, then streams its
// keys in tiles of TK keys (16 KB of K and V rows a tile: 32 keys of
// float32 at Dh 64, 128 of 1-byte codes) through a ring of kStages tiles
// filled by cp.async.cg, 16 bytes a thread (16 codes of a 1-byte cache),
// each tile's scale rows beside it (4 bytes a thread): three tiles (48 KB)
// are in flight while one is folded, and one barrier a tile frees a stage.
// Keys past the block's range are zero-filled by the copy.
// Each of the 4 warps folds its own KW = TK / 4 keys of a tile into its own
// online softmax (as design 1's warps do), with no barrier: LPK = 32 / KW
// neighbouring lanes share a key, each taking CPL = 4 of its K row's
// 16-byte chunks (chunk i LPK + lane % LPK), so log2(LPK) shuffles finish
// a score, never a 5-step reduction a key; the warp's max and sum over its
// keys take 5 - log2(LPK) shuffles a tile; for P·V each lane owns Dh / 32
// output elements of every query row and reads them from each of the
// warp's V rows, with p broadcast by a shuffle. The G rows of a GQA group
// share every loaded row. Rows are stored with their 16-byte chunks
// XOR-swizzled by row (`swz`), so the 8 lanes of a quarter-warp that read
// one chunk each of 8 / LPK keys meet 8 distinct bank groups.
// At the end the warps merge through shared memory in warp order. The
// live splits of a (slot, KV head) are those whose pages meet [lo, hi],
// zlo .. zhi, which every block reads off qpos. A block outside them
// returns at once: an empty split's partial (m -1e30, l 0, acc 0) would
// add exact zeros to the merge's sums, and writing, counting and reading
// it made a launch's time grow with NSPLIT (an all-empty grid in
// `tools/torch_b6_splits.py`). With one live split its block writes
// o; otherwise each live block writes its (m, l, acc[G][Dh]) in float32
// to a workspace, and the last of them to arrive at a counter (each writer
// fences first) merges the live partials in split order and sets the
// counter back to 0 for the next launch: one launch, the same bits
// whichever block arrives last. With no visible key, split 0 writes the
// zero rows.
// Numerics as design 1's: float32 FMA and expf, codes widened to float32
// and scaled as they leave shared memory, the running max from -1e30,
// zeros for a row with no visible key, NaN from a NaN query (fmaxf drops
// it from every max, so m stays finite and exp(s - m) carries it into l
// and acc, which the merges' sums carry on).
namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kTileBytes = 16384;   // K and V rows of one tile
// ops/banded_attention.py (MAX_SPLIT_PAGES, MAX_SPLITS) keeps C and
// NSPLIT within these: the page-table entries of a block, and the merge's
// NSPLIT x G factors, which it keeps in the ring
constexpr int kMaxPages = 256;
constexpr int kMaxSplits = 1024;

template <typename TC, int DH>
struct Geo {
  static constexpr int kRowBytes = DH * (int)sizeof(TC);
  static constexpr int kChunks = kRowBytes / 16;             // a row's
  static constexpr int kTK = kTileBytes / (2 * kRowBytes);   // keys a tile
  static constexpr int kKW = kTK / kWarps;        // keys a warp a tile
  static constexpr int kLPK = 32 / kKW;           // lanes a key (scores)
  static constexpr int kLB = kLPK == 1 ? 0 : kLPK == 2 ? 1 : kLPK == 4 ? 2
                                                                      : 3;
  static constexpr int kCPL = kChunks / kLPK;     // chunks a lane (scores)
  static constexpr int kEPC = 16 / (int)sizeof(TC);   // elements a chunk
  static constexpr int kDPL = DH / 32;            // output elements a lane
  // each thread issues kRows K and kRows V chunks a tile
  static constexpr int kRows = kTK * kChunks / kThreads;
  static_assert(kLPK * kKW == 32 && (1 << kLB) == kLPK && kCPL == 4 &&
                    kRows * kThreads == kTK * kChunks,
                "tile geometry");
};

// The stored chunk of chunk c of tile row r (CH chunks a row, LPK lanes a
// key in the scores): XOR by the row's place among the 8 / LPK rows that a
// quarter-warp reads, so that their chunks i LPK + (0 .. LPK - 1) fall on
// distinct 16-byte bank groups; 64-byte rows (two a 128-byte line) by the
// row's place among the rows of its parity. Within every aligned group of
// 8 chunks, so a warp reading whole rows meets no conflict either.
template <int CH, int LPK>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CH >= 8) return c ^ ((r % (8 / LPK)) * LPK);
  return c ^ ((r >> 1) & (CH - 1));
}

// One 16-byte chunk as floats: 4 float32, or 16 int8 / e4m3 codes (the
// lowest address first).
__device__ __forceinline__ void widen(uint4 w, float (&x)[4], const float*) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void widen(uint4 w, float (&x)[16],
                                      const int8_t*) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * i + b] = (float)(int8_t)(u[i] >> (8 * b));
}
__device__ __forceinline__ void widen(uint4 w, float (&x)[16],
                                      const __nv_fp8_e4m3*) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_fp8x2_storage_t raw =
          (__nv_fp8x2_storage_t)((u[i] >> (16 * h)) & 0xffffu);
      const float2 f = __half22float2(
          __half2(__nv_cvt_fp8x2_to_halfraw2(raw, __NV_E4M3)));
      x[4 * i + 2 * h] = f.x;
      x[4 * i + 2 * h + 1] = f.y;
    }
}

// n = 16 bytes, or 0 to zero-fill the destination
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

// A lane's DPL neighbouring elements of a stored V row, as floats: 8 or 16
// bytes of float32, 2 or 4 codes.
template <int DPL>
__device__ __forceinline__ void widen_v(const unsigned char* p,
                                        float (&x)[DPL], const float*) {
  if constexpr (DPL == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  }
}
template <int DPL>
__device__ __forceinline__ void widen_v(const unsigned char* p,
                                        float (&x)[DPL], const int8_t*) {
#pragma unroll
  for (int e = 0; e < DPL; ++e)
    x[e] = (float)reinterpret_cast<const int8_t*>(p)[e];
}
template <int DPL>
__device__ __forceinline__ void widen_v(const unsigned char* p,
                                        float (&x)[DPL],
                                        const __nv_fp8_e4m3*) {
#pragma unroll
  for (int e = 0; e < DPL; e += 2) {
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        *reinterpret_cast<const __nv_fp8x2_storage_t*>(p + e), __NV_E4M3)));
    x[e] = f.x;
    x[e + 1] = f.y;
  }
}

// Dynamic shared memory, in bytes, in this order.
template <typename TC, int GM, int DH>
struct Smem {
  using Gm = Geo<TC, DH>;
  static constexpr int kRing = kStages * kTileBytes;
  static constexpr int kScales =
      Quant<TC>::value ? kStages * 2 * Gm::kTK * 4 : 0;
  static constexpr int kQ = GM * DH * 4;
  static constexpr int kPT = kMaxPages * 4;
  static constexpr int kRowv = GM * 4 + 16;   // the merge's l; a flag
  static constexpr int bytes = kRing + kScales + kQ + kPT + kRowv;
  // the end of a block reuses the ring: the warps' states, then the
  // merge's factors
  static_assert(kWarps * GM * (DH + 2) * 4 <= kRing &&
                    2 * kMaxSplits * GM * 4 <= kRing,
                "ring reuse");
};

// The part of a design-2 block that both pools share: attend the G query
// rows of (slot s_, KV head hk), already in qs, over the keys [blo, bhi]
// (at least one) of live split zi of nlive, row_of(p) the row index of
// position p's [Dh] row for this KV head (its elements start at
// row_of(p) * Dh, its scales at sk/sv[row_of(p)]); then merge.
template <typename TC, int GM, int DH, typename RowOf>
__device__ __forceinline__ void split_body(
    const TC* __restrict__ kc, const TC* __restrict__ vc,
    const float* __restrict__ sk, const float* __restrict__ sv,
    float* __restrict__ out, float* __restrict__ work,
    int* __restrict__ counters, unsigned char* smem, int s_, int hk, int G,
    int Hkv, size_t row0, int blo, int bhi, int zi, int nlive, int nsplit,
    float scale, RowOf row_of) {
  using Gm = Geo<TC, DH>;
  using Sm = Smem<TC, GM, DH>;
  constexpr int TK = Gm::kTK, CH = Gm::kChunks, EPC = Gm::kEPC;
  constexpr int KW = Gm::kKW, LPK = Gm::kLPK, LB = Gm::kLB;
  constexpr int CPL = Gm::kCPL, DPL = Gm::kDPL, RB = Gm::kRowBytes;
  constexpr bool kQuant = Quant<TC>::value;

  unsigned char* ring = smem;
  float* scl = reinterpret_cast<float*>(smem + Sm::kRing);   // [st][2][TK]
  float* qs = reinterpret_cast<float*>(smem + Sm::kRing + Sm::kScales);
  int* pts = reinterpret_cast<int*>(qs + GM * DH);
  float* rowv = reinterpret_cast<float*>(pts + kMaxPages);   // [GM]
  int* last = reinterpret_cast<int*>(rowv + GM);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkeys = bhi - blo + 1;
  const int ntiles = (nkeys + TK - 1) / TK;

  // the copies of tile `tile` into its stage, as one commit group (empty
  // past the last tile, so that the group count stays in step)
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int stage = tile % kStages;
      const int p0 = blo + tile * TK;
      unsigned char* kst = ring + stage * kTileBytes;
#pragma unroll
      for (int k = 0; k < Gm::kRows; ++k) {
        const int j = tid + k * kThreads;
        const int r = j / CH, c = j % CH;
        const int p = p0 + r;
        const bool live = p <= bhi;
        const size_t row = live ? row_of(p) : 0;
        const int off = r * RB + swz<CH, LPK>(r, c) * 16;
        cp_async16(kst + off, kc + row * DH + c * EPC, live);
        cp_async16(kst + kTileBytes / 2 + off, vc + row * DH + c * EPC,
                   live);
      }
      if constexpr (kQuant) {
        for (int j = tid; j < 2 * TK; j += kThreads) {
          const int kv = j / TK, r = j % TK, p = p0 + r;
          const bool live = p <= bhi;
          const size_t row = live ? row_of(p) : 0;
          cp_async4(scl + (stage * 2 + kv) * TK + r, (kv ? sv : sk) + row,
                    live);
        }
      }
    }
    cp_async_commit();
  };

  // this warp's online softmax: m and l (the same in every lane), and the
  // lane's elements lane DPL .. + DPL - 1 of each query row's accumulator
  float m[GM], l[GM], acc[GM][DPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }
  const int u = lane >> LB, li = lane & (LPK - 1);
  const int r = warp * KW + u;   // this lane's key in a tile (scores)
  // P·V: this lane's elements of a V row, in the chunk vchunk at vbyte
  const int vchunk = lane * DPL * (int)sizeof(TC) / 16;
  const int vbyte = lane * DPL * (int)sizeof(TC) % 16;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile landed; every warp is done with tile - 1
    issue(tile + kStages - 1);
    const int stage = tile % kStages;
    const unsigned char* kst = ring + stage * kTileBytes;
    const unsigned char* vst = kst + kTileBytes / 2;
    const float* sks = scl + stage * 2 * TK;
    const float* svs = sks + TK;
    // the warp's live keys in this tile
    const int nw = min(KW, nkeys - tile * TK - warp * KW);
    if (nw <= 0) continue;

    // scores of key r over this lane's chunks, then over its LPK lanes
    float sc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) sc[g] = 0.f;
    const float fk = kQuant ? sks[r] : 1.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = i * LPK + li;
      const uint4 w = *reinterpret_cast<const uint4*>(
          kst + r * RB + swz<CH, LPK>(r, c) * 16);
      float x[EPC];
      widen(w, x, static_cast<const TC*>(nullptr));
      if (kQuant) {
#pragma unroll
        for (int e = 0; e < EPC; ++e) x[e] *= fk;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int e4 = 0; e4 < EPC / 4; ++e4) {
          const float4 qq = *reinterpret_cast<const float4*>(
              qs + g * DH + c * EPC + 4 * e4);
          sc[g] = fmaf(qq.x, x[4 * e4], sc[g]);
          sc[g] = fmaf(qq.y, x[4 * e4 + 1], sc[g]);
          sc[g] = fmaf(qq.z, x[4 * e4 + 2], sc[g]);
          sc[g] = fmaf(qq.w, x[4 * e4 + 3], sc[g]);
        }
      }
    }
    const bool live = u < nw;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1)
        sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
      const float s = sc[g] * scale;
      // the warp's max over its live keys (fmaxf leaves out a NaN score)
      float mx = live ? fmaxf(kNegInf, s) : kNegInf;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      const float p = live ? expf(s - m_new) : 0.f;
      float lt = p;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, o);
      l[g] = l[g] * alpha + lt;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
      sc[g] = p;
    }

    // P·V over the warp's keys, in key order (unrolled, so the V loads
    // and p's broadcasts of the KW keys go out together; a key past the
    // range has p 0 and a zero-filled V row)
#pragma unroll
    for (int uu = 0; uu < KW; ++uu) {
      const int rr = warp * KW + uu;
      float v[DPL];
      widen_v<DPL>(vst + rr * RB + swz<CH, LPK>(rr, vchunk) * 16 + vbyte, v,
                   static_cast<const TC*>(nullptr));
      if (kQuant) {
        const float fv = svs[rr];
#pragma unroll
        for (int e = 0; e < DPL; ++e) v[e] *= fv;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = __shfl_sync(0xffffffffu, sc[g], uu * LPK);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps' states go there
  float* wm = reinterpret_cast<float*>(ring);   // [kWarps][GM]
  float* wl = wm + kWarps * GM;                 // [kWarps][GM]
  float* wacc = wl + kWarps * GM;               // [kWarps][GM][DH]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      wm[warp * GM + g] = m[g];
      wl[warp * GM + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      wacc[(warp * GM + g) * DH + lane * DPL + e] = acc[g][e];
  }
  __syncthreads();

  // the warps' partial softmaxes merged in warp order, then written: o
  // (the only live split), or this split's (m, l, acc) in live split zi
  const int stride = G * (DH + 2);   // a partial: m[G], l[G], acc[G][DH]
  float* all = work + (size_t)(s_ * Hkv + hk) * nsplit * (size_t)stride;
  float* mine = nlive > 1 ? all + (size_t)zi * stride : nullptr;
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm[w * GM + g]);
    float lb = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w * GM + g] - mb);
      lb = fmaf(wl[w * GM + g], c, lb);
      o = fmaf(wacc[w * GM * DH + i], c, o);
    }
    if (nlive == 1) {
      out[row0 + i] = o / fmaxf(lb, 1e-30f);
    } else {
      mine[2 * G + i] = o;
      if (i % DH == 0) {
        mine[g] = mb;
        mine[G + g] = lb;
      }
    }
  }
  if (nlive == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *last = atomicAdd(counters + s_ * Hkv + hk, 1) == nlive - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // The last live block: merge the live splits' partials in split order.
  // Their loads go out together (from L2), not one split after another:
  // m and l of every split, and this thread's first output over the first
  // 8 splits.
  float* cf = reinterpret_cast<float*>(ring);   // [live][G]: m, then c
  float* lf = cf + kMaxSplits * GM;             // [live][G]: l
  float a0[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    a0[k] = tid < G * DH && k < nlive
                ? __ldcg(all + (size_t)k * stride + 2 * G + tid)
                : 0.f;
  for (int i = tid; i < nlive * G; i += kThreads) {
    const float* pj = all + (size_t)(i / G) * stride + i % G;
    const float mj = __ldcg(pj), lj = __ldcg(pj + G);
    cf[i] = mj;
    lf[i] = lj;
  }
  __syncthreads();
  if (tid < G) {
    float mt = kNegInf;
    for (int j = 0; j < nlive; ++j) mt = fmaxf(mt, cf[j * G + tid]);
    float lt = 0.f;
    for (int j = 0; j < nlive; ++j) {
      const float c = expf(cf[j * G + tid] - mt);
      cf[j * G + tid] = c;
      lt = fmaf(lf[j * G + tid], c, lt);
    }
    rowv[tid] = lt;
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH;
    float o = 0.f;
    for (int j0 = 0; j0 < nlive; j0 += 8) {
      float a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        a[k] = i == tid && j0 == 0 ? a0[k]
               : j0 + k < nlive
                   ? __ldcg(all + (size_t)(j0 + k) * stride + 2 * G + i)
                   : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (j0 + k < nlive) o = fmaf(a[k], cf[(j0 + k) * G + g], o);
    }
    out[row0 + i] = o / fmaxf(rowv[g], 1e-30f);
  }
  if (tid == 0) counters[s_ * Hkv + hk] = 0;
}

// The block's query rows into qs (rows past G zeros).
template <int GM, int DH>
__device__ __forceinline__ void load_q(const float* __restrict__ q,
                                       float* qs, size_t row0, int G) {
  for (int i = threadIdx.x; i < GM * DH; i += kThreads)
    qs[i] = i < G * DH ? q[row0 + i] : 0.f;
}

// B6 / B6q: block (s, hk, z) owns the C logical pages [zC, zC + C).
template <typename TC, int GM, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_split_kernel(
    const float* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, const float* __restrict__ sk,
    const float* __restrict__ sv, float* __restrict__ out,
    const int* __restrict__ page_table, const int* __restrict__ qpos,
    float* __restrict__ work, int* __restrict__ counters, int NP, int Lp,
    int lp_shift, int H, int Hkv, int window, int C, float scale) {
  using Sm = Smem<TC, GM, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Sm::kRing + Sm::kScales);
  int* pts = reinterpret_cast<int*>(qs + GM * DH);

  const int s_ = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / Hkv;
  const size_t row0 = ((size_t)s_ * H + (size_t)hk * G) * DH;
  const int pos = qpos[s_];
  const int pfirst = z * C;
  // the block's C table entries (known from the grid alone, so their
  // loads go out beside qpos's) and the query rows
  for (int i = tid; i < min(C, NP - pfirst); i += kThreads)
    pts[i] = page_table[(size_t)s_ * NP + pfirst + i];
  load_q<GM, DH>(q, qs, row0, G);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int hi = min(pos, NP * Lp - 1);
  // the live splits zlo .. zhi: those whose pages meet [lo, hi]
  const int zlo = lo / (C * Lp), zhi = hi >= lo ? hi / (C * Lp) : zlo - 1;
  const int nlive = zhi - zlo + 1;
  if (z < zlo || z > zhi) {
    // outside the range: no partial and no count; with no visible key at
    // all, split 0 writes the zero rows
    if (nlive == 0 && z == 0)
      for (int i = tid; i < G * DH; i += kThreads) out[row0 + i] = 0.f;
    return;
  }
  const int blo = max(lo, pfirst * Lp);
  const int bhi = min(hi, (pfirst + C) * Lp - 1);
  __syncthreads();

  // the row index of position p's [Dh] row for this KV head (a shift for
  // a power-of-two page length, lp_shift >= 0)
  auto row_of = [&](int p) -> size_t {
    const int pg = lp_shift >= 0 ? p >> lp_shift : p / Lp;
    return ((size_t)pts[pg - pfirst] * Lp + (p - pg * Lp)) * Hkv + hk;
  };
  split_body<TC, GM, DH>(kc, vc, sk, sv, out, work, counters, smem, s_, hk,
                         G, Hkv, row0, blo, bhi, z - zlo, nlive, gridDim.z,
                         scale, row_of);
}

// B5 / B5q: block (s, hk, z) owns the live split zlo + z of the slot's
// logical positions in chunks of C, zlo = lo / C; the ring's slot of
// position p is p mod L (p >= 0), so a chunk that wraps the ring reads
// its keys from two runs of rows, each key by its own row.
template <typename TC, int GM, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(
    const float* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, const float* __restrict__ sk,
    const float* __restrict__ sv, float* __restrict__ out,
    const int* __restrict__ qpos, const int* __restrict__ endp,
    float* __restrict__ work, int* __restrict__ counters, int L, int H,
    int Hkv, int window, int rolling, int C, float scale) {
  using Sm = Smem<TC, GM, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Sm::kRing + Sm::kScales);

  const int s_ = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / Hkv;
  const size_t row0 = ((size_t)s_ * H + (size_t)hk * G) * DH;
  const int pos = qpos[s_];
  const int end = rolling ? endp[s_] : 0;
  load_q<GM, DH>(q, qs, row0, G);
  // the visible range, as design 1 reads it
  int lo = window > 0 ? max(0, pos - window + 1) : 0;
  int hi = min(pos, L - 1);
  if (rolling) {
    lo = max(lo, end - L + 1);
    hi = min(pos, end);
  }
  const int nlive = hi >= lo ? hi / C - lo / C + 1 : 0;
  if (z >= nlive) {
    if (nlive == 0 && z == 0)
      for (int i = tid; i < G * DH; i += kThreads) out[row0 + i] = 0.f;
    return;
  }
  const int c0 = (lo / C + z) * C;
  const int blo = max(lo, c0), bhi = min(hi, c0 + C - 1);
  __syncthreads();

  const size_t slot0 = (size_t)s_ * L;
  auto row_of = [=](int p) -> size_t {
    return (slot0 + (rolling ? p % L : p)) * Hkv + hk;
  };
  split_body<TC, GM, DH>(kc, vc, sk, sv, out, work, counters, smem, s_, hk,
                         G, Hkv, row0, blo, bhi, z, nlive, gridDim.z, scale,
                         row_of);
}

struct Args {
  const float* q;
  const void *k, *v;
  const float *sk, *sv;
  float* out;
  const int *page_table, *qpos;
  float* work;
  int* counters;
  int S, NP, Lp, lp_shift, H, Hkv, window, C;
  float scale;
};

struct SlotArgs {
  const float* q;
  const void *k, *v;
  const float *sk, *sv;
  float* out;
  const int *qpos, *end;
  float* work;
  int* counters;
  int S, L, H, Hkv, window, rolling, C;
  float scale;
};

// Each launcher instantiation raises its kernel's dynamic shared-memory
// limit once (a function-local static is per instantiation).
template <typename TC, int GM, int DH>
int launch(const Args& a, int nsplit, cudaStream_t st) {
  constexpr int smem = Smem<TC, GM, DH>::bytes;
  static const cudaError_t once = cudaFuncSetAttribute(
      paged_decode_attention_split_kernel<TC, GM, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (once != cudaSuccess) return (int)once;
  paged_decode_attention_split_kernel<TC, GM, DH>
      <<<dim3(a.S, a.Hkv, nsplit), kThreads, smem, st>>>(
          a.q, static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
          a.sk, a.sv, a.out, a.page_table, a.qpos, a.work, a.counters, a.NP,
          a.Lp, a.lp_shift, a.H, a.Hkv, a.window, a.C, a.scale);
  return (int)cudaGetLastError();
}

template <typename TC, int GM, int DH>
int launch(const SlotArgs& a, int nsplit, cudaStream_t st) {
  constexpr int smem = Smem<TC, GM, DH>::bytes;
  static const cudaError_t once = cudaFuncSetAttribute(
      decode_attention_split_kernel<TC, GM, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (once != cudaSuccess) return (int)once;
  decode_attention_split_kernel<TC, GM, DH>
      <<<dim3(a.S, a.Hkv, nsplit), kThreads, smem, st>>>(
          a.q, static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
          a.sk, a.sv, a.out, a.qpos, a.end, a.work, a.counters, a.L, a.H,
          a.Hkv, a.window, a.rolling, a.C, a.scale);
  return (int)cudaGetLastError();
}

template <typename TC, int DH, typename A>
int launch_group(const A& a, int nsplit, cudaStream_t st) {
  const int G = a.H / a.Hkv;
  if (G <= 1) return launch<TC, 1, DH>(a, nsplit, st);
  if (G <= 2) return launch<TC, 2, DH>(a, nsplit, st);
  if (G <= 4) return launch<TC, 4, DH>(a, nsplit, st);
  return launch<TC, 8, DH>(a, nsplit, st);
}

template <typename TC, typename A>
int launch_cache(const A& a, int Dh, int nsplit, cudaStream_t st) {
  return Dh == 64 ? launch_group<TC, 64>(a, nsplit, st)
                  : launch_group<TC, 128>(a, nsplit, st);
}

// float32 q and out over cache_dtype 0 = float32, 2 = int8 or 3 = e4m3
// codes with scale rows
template <typename A>
int launch_dtype(const A& a, int Dh, int nsplit, int cache_dtype,
                 cudaStream_t st) {
  if (cache_dtype == 0) return launch_cache<float>(a, Dh, nsplit, st);
  if (!a.sk || !a.sv) return (int)cudaErrorInvalidValue;
  if (cache_dtype == 2) return launch_cache<int8_t>(a, Dh, nsplit, st);
  if (cache_dtype == 3) return launch_cache<__nv_fp8_e4m3>(a, Dh, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace split

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

// Design 2 of B6/B6q: float32 q and out over cache_dtype 0 = float32, 2 =
// int8 or 3 = e4m3 codes with scale rows; Dh 64 or 128; split_pages C
// pages a block. With NSPLIT = ceil(NP / C) > 1, work holds
// S * Hkv * NSPLIT * G * (Dh + 2) floats and counters S * Hkv ints, zero
// before the first launch (each launch leaves them zero). Returns 0 or a
// cudaError_t code.
int dl4j_paged_decode_attention_split(
    const float* q, const void* k, const void* v, const float* scale_k,
    const float* scale_v, float* out, const int* page_table, const int* qpos,
    float* work, int* counters, int S, int NP, int Lp, int H, int Hkv,
    int Dh, int window, int split_pages, float scale, int cache_dtype,
    void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxG || (Dh != 64 && Dh != 128)
      || NP < 1 || Lp < 1 || split_pages < 1
      || split_pages > split::kMaxPages)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (NP + split_pages - 1) / split_pages;
  if (nsplit > split::kMaxSplits || (nsplit > 1 && (!work || !counters)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const int lp_shift = (Lp & (Lp - 1)) == 0 ? __builtin_ctz(Lp) : -1;
  const split::Args a{q, k, v, scale_k, scale_v, out, page_table, qpos,
                      work, counters, S, NP, Lp, lp_shift, H, Hkv, window,
                      split_pages, scale};
  return split::launch_dtype(a, Dh, nsplit, cache_dtype,
                             static_cast<cudaStream_t>(stream));
}

// Design 2 of B5/B5q: float32 q and out over cache_dtype 0 = float32, 2 =
// int8 or 3 = e4m3 codes with scale rows; Dh 64 or 128; chunks of
// split_keys C positions, NSPLIT blocks a slot and KV head, at least the
// live chunks a range can meet (ceil(min(window, L) / C) + 1 with a window,
// ceil(L / C) without). With NSPLIT > 1, work holds
// S * Hkv * NSPLIT * G * (Dh + 2) floats and counters S * Hkv ints, zero
// before the first launch (each launch leaves them zero). Returns 0 or a
// cudaError_t code.
int dl4j_decode_attention_split(
    const float* q, const void* k, const void* v, const float* scale_k,
    const float* scale_v, float* out, const int* qpos, const int* end,
    float* work, int* counters, int S, int L, int H, int Hkv, int Dh,
    int window, int rolling, int split_keys, int nsplit, float scale,
    int cache_dtype, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxG || (Dh != 64 && Dh != 128)
      || L < 1 || split_keys < 1 || (rolling && window < 1))
    return (int)cudaErrorInvalidValue;
  const int span = window > 0 && window < L ? window : L;
  const int need = (span + split_keys - 1) / split_keys + (window > 0);
  if (nsplit < need || nsplit > split::kMaxSplits ||
      (nsplit > 1 && (!work || !counters)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const split::SlotArgs a{q, k, v, scale_k, scale_v, out, qpos, end, work,
                          counters, S, L, H, Hkv, window, rolling,
                          split_keys, scale};
  return split::launch_dtype(a, Dh, nsplit, cache_dtype,
                             static_cast<cudaStream_t>(stream));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
