"""Ablations of B3a's design 3 (the float32 flash forward as 3xTF32 on
`mma.sync`, `tf32x3::fwd_tf32x3_kernel`), on the card.

Each variant is `csrc/flash_attention.cu` with choices of the design
undone by text patches, built by its own `nvcc` (all at once) into
`build/b3a_variants/` and launched through its `dl4j_flash_fwd_tf32x3`:

- final: the source as it is;
- s_rolled: the score product's k-steps rolled by two (the backward's
  choice) instead of fully unrolled;
- kv_planes: at Dh 64 the streamed K and V tiles split once a block into
  big and small planes behind a second barrier (the backward's choice)
  instead of at each fragment load;
- q_planes: the pinned Q split once, at the first tile, into big and
  small planes instead of at each fragment load;
- pv_chained: P·V's big·big products chained over the tile's k-steps in
  an accumulator of their own, added to O once a tile, instead of from a
  zero accumulator each k-step (the guard decides whether it may run);
- first: s_rolled, kv_planes and q_planes together (this design's first
  version).

At `path_t`'s shape (BH 64, T 2048, Dh 64, causal), `path_x`'s (BH 64,
Tq 2048, Tk 1024) and Dh 128 (BH 64, T 1024, causal), on seeded inputs,
each variant is timed twice in turns (first to last, then last to
first; CUDA events after a 256 MB L2 flush, `chip_smoke.time_ms`), with
its largest error against the plain float32 forward (o and lse) and the
guard: its largest error against the plain forward in float64 over
design 1's, on o and on lse. One JSON line a shape, the card's name and
power limit first.

    python tools/torch_b3a_variants.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SRC = HERE / "deeplearning4j_tpu_torch" / "csrc" / "flash_attention.cu"
OUT = HERE / "build" / "b3a_variants"
SHAPES = {"path_t": (64, 2048, 2048, 64, True),
          "path_x": (64, 2048, 1024, 64, False),
          "dh128": (64, 1024, 1024, 128, True)}
VARIANTS = {"final": set(), "s_rolled": {"s_rolled"},
            "kv_planes": {"kv_planes"}, "q_planes": {"q_planes"},
            "pv_chained": {"pv_chained"},
            "first": {"s_rolled", "kv_planes", "q_planes"}}

# helpers the variants add in front of the forward kernel
_HELPERS = r"""
// S = Q K^T with Q's big and small planes (qb, qs) read as they lie
template <int DH, int kUnroll, typename B>
__device__ __forceinline__ void rows_product_qp(
    float (&acc)[Geo3<DH>::CT][4], const float* qb, const float* qs,
    const B& sB, int g, int t) {
  constexpr int LD = Geo3<DH>::LD, CT = Geo3<DH>::CT;
  float lo[CT][4];
  zero(acc);
  zero(lo);
#pragma unroll (kUnroll)
  for (int kk = 0; kk < DH / 8; ++kk) {
    const int o = g * LD + 8 * kk + t;
    const int off[4] = {o, o + 8 * LD, o + 4, o + 8 * LD + 4};
    FragA fa(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fa.big[e] = __float_as_uint(qb[off[e]]);
      fa.small[e] = __float_as_uint(qs[off[e]]);
    }
    const B b = sB + o;
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

// O += P V with each k-step's big * big chained over the tile
template <int DH, typename B>
__device__ __forceinline__ void cols_product_chained(
    float (&acc)[DH / 8][4], const float (&p)[Geo3<DH>::CT][4],
    const B& sB, int g, int t) {
  constexpr int LD = Geo3<DH>::LD;
#pragma unroll
  for (int c = 0; c < DH / 64; ++c) {
    float lo[8][4], hi[8][4];
    zero(lo);
    zero(hi);
#pragma unroll
    for (int j = 0; j < Geo3<DH>::CT; ++j) {
      const FragA fa(p[j][0], p[j][2], p[j][1], p[j][3]);
      const B b = sB + ((8 * j + 2 * t) * LD + 64 * c + g);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        b.at(8 * n, bb0, bs0);
        b.at(LD + 8 * n, bb1, bs1);
        mma(lo[n], fa.small, bb0, bb1);
        mma(lo[n], fa.big, bs0, bs1);
        mma(hi[n], fa.big, bb0, bb1);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[8 * c + n][e] += hi[n][e] + lo[n][e];
  }
}

"""
_KERNEL = "// B3a, design 3. Block (bh, qb) owns kRows queries"
_LAUNCH = ("template <int DH>\nint launch(Which w, const Args& a, "
           "cudaStream_t st) {")
_S_CALL = "    rows_product<DH, DH / 8>(s, wQ, bk, g, t);  // S = Q K^T"
_STAGE = """    const float* st = ring + (i % kStages) * G::kStage;
    const BRaw bk{st}, bv{st + G::kTile};"""
_STAGE_PLANES = """    float* st = ring + (i % kStages) * G::kStage;
    if constexpr (G::kPreSplit) {
      split_tiles<DH>(st, small);
      __syncthreads();
    }
    const StageB<DH> sb(st, small);
    const auto bk = sb.x;
    const auto bv = sb.y;"""
_RING = "  float* ring = sQ + kRows * G::LD;\n"
# the K/V planes after the ring, then Q's small plane
_PLANES = ("  float* small = ring + kStages * G::kStage;\n"
           "  float* sQs = small + (G::kPreSplit ? 2 * G::kTile : 0);\n")
_ISSUE = "    issue(i + kStages - 1);\n"
_Q_SPLIT = """    if (i == 0) {
      split_tiles<DH, kRows>(sQ, sQs);
      __syncthreads();
    }
"""
# split_tiles over R rows (the pinned Q's kRows)
_SPLIT_OLD = """template <int DH>
__device__ __forceinline__ void split_tiles(float* x, float* small) {
  using G = Geo3<DH>;
  constexpr int kChunks = DH / 4;
  static_assert(2 * G::kCols * kChunks % kThreads == 0, "tile split");
#pragma unroll
  for (int c = 0; c < 2 * G::kCols * kChunks / kThreads; ++c) {"""
_SPLIT_NEW = """template <int DH, int R = 2 * Geo3<DH>::kCols>
__device__ __forceinline__ void split_tiles(float* x, float* small) {
  using G = Geo3<DH>;
  constexpr int kChunks = DH / 4;
  static_assert(R * kChunks % kThreads == 0, "tile split");
#pragma unroll
  for (int c = 0; c < R * kChunks / kThreads; ++c) {"""


def _patch(src, old, new, count=1):
    if src.count(old) != count:
        raise RuntimeError(f"patch does not apply: {old!r}")
    return src.replace(old, new)


def variant_source(text, features):
    """The source with `features` undone (see the module's docstring)."""
    if not features:
        return text
    # the forward kernel's own lines are patched within its text
    k0 = text.index(_KERNEL)
    k1 = text.index(_LAUNCH, k0)
    kern = _patch(text[k0:k1], _RING, _RING + _PLANES)
    q = "q_planes" in features
    if "kv_planes" in features:
        kern = _patch(kern, _STAGE, _STAGE_PLANES)
    unroll = "2" if "s_rolled" in features else "DH / 8"
    if q:
        kern = _patch(kern, _ISSUE, _ISSUE + _Q_SPLIT)
        kern = _patch(kern, _S_CALL, (
            f"    rows_product_qp<DH, {unroll}>(s, wQ, sQs + 16 * warp * "
            f"G::LD, bk, g, t);"))
    elif "s_rolled" in features:
        kern = _patch(kern, _S_CALL,
                      "    rows_product<DH>(s, wQ, bk, g, t);")
    if "pv_chained" in features:
        kern = _patch(kern, "cols_product<DH>(oa, s, bv, g, t);",
                      "cols_product_chained<DH>(oa, s, bv, g, t);")
    pre = _patch(text[:k0], _SPLIT_OLD, _SPLIT_NEW) + _HELPERS
    extra = "(G::kPreSplit ? 2 * G::kTile : 0)" + (
        " + kRows * G::LD" if q else "")
    post = _patch(text[k1:], "G::kFwdBytes",
                  f"(G::kFwdBytes + ({extra}) * 4)", count=2)
    return pre + kern + post


def build(cuda_build):
    """{variant: the launch function of its library}; raises if a patch
    does not apply or a build fails."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, features in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(text, features))
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC), "-o", str(OUT / f"lib{name}.so"),
               str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).dl4j_flash_fwd_tf32x3
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
        fns[name] = fn
    return fns


def run(shape_name, shape, fns, flush, cs, fa):
    bh, tq, tk, dh, causal = shape
    g = torch.Generator().manual_seed(24)
    q = torch.randn(bh, tq, dh, generator=g).cuda()
    k, v = (torch.randn(bh, tk, dh, generator=g).cuda() for _ in range(2))
    ref = fa.flash_attention_plain(q, k, v, causal)
    ref64 = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                     causal)
    f1 = [cs.f64_share((a,), (r,)) for a, r in
          zip(fa.launch_fwd(q, k, v, causal, design="ffma"), ref64)]
    o = torch.empty_like(q)
    lse = torch.empty(bh, tq, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    row = {"shape": shape_name, "bh": bh, "tq": tq, "tk": tk, "dh": dh,
           "causal": causal, "variants": {}}
    order = list(fns) + list(reversed(list(fns)))
    for name in order:
        def call(fn=fns[name]):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), bh, tq, tk, dh, dh ** -0.5, int(causal),
                    stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        entry = row["variants"].setdefault(name, {"ms": []})
        if "guard_ratio" not in entry:
            entry["max_abs_err"] = {n: (a - r).abs().max().item() for n, a, r
                                    in zip(("o", "lse"), (o, lse), ref)}
            entry["guard_ratio"] = {
                n: cs.f64_share((a,), (r,)) / f for n, a, r, f in
                zip(("o", "lse"), (o, lse), ref64, f1)}
        entry["ms"].append(cs.time_ms(call, flush))
    print(json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_b3a_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import attention as fa
    from deeplearning4j_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_limit(), flush=True)
    fns = build(cuda_build)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for name, shape in SHAPES.items():
        run(name, shape, fns, flush, cs, fa)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
