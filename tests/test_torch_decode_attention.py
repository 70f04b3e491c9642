"""Decode attention of the port (`deeplearning4j_tpu_torch/ops/
banded_attention.py`) against the JAX package's decode kernels B5 and
B6, run as the JAX tests run them on the CPU (Pallas in interpret mode),
and against the JAX dense oracle `decode_reference`.

On the CPU the port's wrappers take their plain versions; the CUDA
kernels themselves are held against those plain versions on the card
(`tests/test_torch_cuda_kernels.py` and `chip_smoke.py`). Rows with no
visible key are garbage by contract on every path, so only live rows
are compared.
Tolerance: 1e-5 abs/rel, float32 on both sides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.banded_attention import (
    banded_decode_attention as jax_banded_decode,
    decode_reference as jax_decode_reference,
    paged_decode_attention as jax_paged_decode,
)
from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv
from deeplearning4j_tpu_torch.ops import banded_attention as ba

TOL = dict(atol=1e-5, rtol=1e-5)


def _vis(qpos, end, L, window, rolling):
    j = np.arange(L)[None, :]
    qp = qpos[:, None]
    if rolling:
        held = end[:, None] - np.mod(end[:, None] - j, L)
        return (held >= 0) & (held <= qp) & (held > qp - window)
    vis = j <= qp
    if window is not None:
        vis = vis & (j > qp - window)
    return vis


def _inputs(rng, S, L, H, Hkv, Dh):
    q = rng.standard_normal((S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((S, L, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((S, L, Hkv, Dh)).astype(np.float32)
    return q, k, v


MODES = [("linear", None, False), ("window", 5, False),
         ("rolling", 6, True)]


@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["g1", "g2", "g4"])
@pytest.mark.parametrize("mode,window,rolling", MODES,
                         ids=[m[0] for m in MODES])
def test_plain_b5_matches_jax_kernel_and_reference(mode, window, rolling,
                                                   hkv):
    rng = np.random.default_rng([len(mode), hkv])
    S, L, H, Dh = 6, 24, 4, 8
    q, k, v = _inputs(rng, S, L, H, hkv, Dh)
    if rolling:
        # before, at and well past the ring's length: the ring wraps, and
        # end - j is negative early in a stream (floor-mod on both sides)
        qpos = np.array([0, 3, 23, 24, 37, 90], np.int32)
    else:
        qpos = np.array([0, 3, 7, 12, 20, 23], np.int32)
    end = qpos.copy()
    sc = Dh ** -0.5
    want_kernel = np.asarray(jax_banded_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(end), window=window, rolling=rolling, block_l=8,
        interpret=True))
    want_ref = np.asarray(jax_decode_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(end), window, rolling, sc))
    got = ba.banded_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qpos), torch.from_numpy(end), window=window,
        rolling=rolling).numpy()
    live = _vis(qpos, end, L, window, rolling).any(axis=1)
    assert live.all()
    np.testing.assert_allclose(got[live], want_kernel[live], **TOL)
    np.testing.assert_allclose(got[live], want_ref[live], **TOL)


def test_plain_b5_rolling_end_ahead_of_query():
    """A prefill chunk's first query sees the ring as the chunk's LAST
    write left it (end > qpos): the held-index rule hides the slots the
    chunk overwrote past the query."""
    rng = np.random.default_rng(5)
    S, L, H, Hkv, Dh, w = 3, 16, 4, 2, 8, 5
    q, k, v = _inputs(rng, S, L, H, Hkv, Dh)
    qpos = np.array([2, 17, 40], np.int32)
    end = qpos + np.array([3, 6, 10], np.int32)
    want = np.asarray(jax_decode_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(end), w, True, Dh ** -0.5))
    got = ba.banded_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qpos), torch.from_numpy(end), window=w,
        rolling=True).numpy()
    live = _vis(qpos, end, L, w, True).any(axis=1)
    np.testing.assert_allclose(got[live], want[live], **TOL)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("hkv", [4, 1], ids=["g1", "g4"])
def test_plain_b6_matches_jax_paged_kernel(hkv, window):
    """Slots share physical pages (a prefix chain), tables point at
    scattered pages, unmapped entries hold page 0."""
    rng = np.random.default_rng(11 + hkv)
    S, Lp, NP, H, Dh = 4, 8, 4, 4, 8
    P = 12
    q = rng.standard_normal((S, H, Dh)).astype(np.float32)
    ck = rng.standard_normal((P, Lp, hkv, Dh)).astype(np.float32)
    cv = rng.standard_normal((P, Lp, hkv, Dh)).astype(np.float32)
    pt = np.array([[3, 7, 1, 0],
                   [3, 7, 9, 0],          # shares slot 0's first pages
                   [3, 5, 0, 0],
                   [11, 2, 6, 4]], np.int32)
    qpos = np.array([17, 20, 9, 31], np.int32)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pt),
        jnp.asarray(qpos), window=window, interpret=True))
    got = ba.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(pt), torch.from_numpy(qpos),
        window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # and the same as B5's plain version over the gathered logical cache
    logical_k = ck[pt].reshape(S, NP * Lp, hkv, Dh)
    logical_v = cv[pt].reshape(S, NP * Lp, hkv, Dh)
    flat = ba.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(logical_k),
        torch.from_numpy(logical_v), torch.from_numpy(qpos),
        torch.from_numpy(qpos), window=window).numpy()
    np.testing.assert_allclose(got, flat, **TOL)


# bfloat16 (C6). JAX's decode kernels round p to bfloat16 where it meets
# v, against the running max of their cache blocks (block_l, or a page).
# The plain versions do the same: with JAX's blocks (`block_k`) they are
# held to 1e-3 of the largest |JAX| value (they agree exactly on these
# shapes), and with the row max (the default, where the CUDA decode
# kernels round) to one bf16 step of |o| (2^-7) plus that 1e-3 (at most
# 4e-4 past the step). Unrounded, as before the repair, they were 1.7e-3
# to 3.4e-3 of it apart: 1.7-3.4x the tolerance.
BF16_DECODE_ATOL = 1e-3


def _bf16(rng, shape):
    a = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return a, torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("mode,window,rolling", MODES,
                         ids=[m[0] for m in MODES])
def test_plain_b5_bf16_rounds_p_like_jax_kernel(mode, window, rolling):
    rng = np.random.default_rng([7, len(mode)])
    S, L, H, Hkv, Dh = 6, 24, 4, 2, 8
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, s) for s in (
        (S, H, Dh), (S, L, Hkv, Dh), (S, L, Hkv, Dh)))
    qpos = np.array([0, 3, 23, 24, 37, 90] if rolling
                    else [0, 3, 7, 12, 20, 23], np.int32)
    want = np.asarray(jax_banded_decode(
        jq, jk, jv, jnp.asarray(qpos), jnp.asarray(qpos), window=window,
        rolling=rolling, block_l=8, interpret=True).astype(jnp.float32))
    tol = BF16_DECODE_ATOL * np.abs(want).max()
    pos = torch.from_numpy(qpos)
    got = ba.decode_attention_plain(q, k, v, pos, pos, window=window,
                                    rolling=rolling, block_k=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    row = ba.banded_decode_attention(q, k, v, pos, pos, window=window,
                                     rolling=rolling)   # the CPU wrapper
    np.testing.assert_allclose(row.float().numpy(), want, rtol=2.0 ** -7,
                               atol=tol)


@pytest.mark.parametrize("window", [None, 6])
def test_plain_b6_bf16_rounds_p_like_jax_kernel(window):
    rng = np.random.default_rng(21)
    S, Lp, H, Hkv, Dh, P = 4, 8, 4, 2, 8, 12
    (jq, q), (jk, k), (jv, v) = (_bf16(rng, s) for s in (
        (S, H, Dh), (P, Lp, Hkv, Dh), (P, Lp, Hkv, Dh)))
    pt = np.array([[3, 7, 1, 0], [3, 7, 9, 0], [3, 5, 0, 0], [11, 2, 6, 4]],
                  np.int32)
    qpos = np.array([17, 20, 9, 31], np.int32)
    want = np.asarray(jax_paged_decode(
        jq, jk, jv, jnp.asarray(pt), jnp.asarray(qpos), window=window,
        interpret=True).astype(jnp.float32))
    tol = BF16_DECODE_ATOL * np.abs(want).max()
    tp, pos = torch.from_numpy(pt), torch.from_numpy(qpos)
    got = ba.paged_decode_attention_plain(q, k, v, tp, pos, window=window,
                                          block_k=Lp)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    row = ba.paged_decode_attention(q, k, v, tp, pos, window=window)
    np.testing.assert_allclose(row.float().numpy(), want, rtol=2.0 ** -7,
                               atol=tol)


def test_wrappers_on_cpu_take_the_plain_version_and_count_no_launch():
    ba.reset_counts()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 2, 8, 2, 2, 4))
    pos = torch.tensor([3, 7], dtype=torch.int32)
    ba.banded_decode_attention(q, k, v, pos, pos)
    ba.paged_decode_attention(q, k, v, torch.tensor([[0], [1]],
                                                    dtype=torch.int32), pos)
    for counts in (ba.LAUNCHES, ba.PLAIN_ON_CUDA):
        assert {"banded_decode_attention", "paged_decode_attention"} <= \
            set(counts)
        assert not any(counts.values()), counts


def test_nan_query_passes_through_the_plain_version():
    """The layers poison an overflowing lane's query with NaN; attention
    must hand it on, not hide it."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 2, 8, 2, 2, 4))
    q[1] = float("nan")
    pos = torch.tensor([3, 7], dtype=torch.int32)
    out = ba.banded_decode_attention(q, k, v, pos, pos)
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()


@pytest.mark.parametrize("bad", ["heads", "slots", "rolling"])
def test_wrapper_rejects_bad_shapes(bad):
    q = torch.zeros(2, 3, 4)
    k = torch.zeros(2, 8, 2, 4)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "heads":
            ba.banded_decode_attention(q, k, k, pos, pos)
        elif bad == "slots":
            ba.banded_decode_attention(torch.zeros(2, 4, 4), k, k,
                                       pos[:1], pos[:1])
        else:
            ba.banded_decode_attention(torch.zeros(2, 4, 4), k, k, pos,
                                       pos, rolling=True)


# ------------------------------------- B6/B6q design 2: choice and splits
H100_SMS = 132


@pytest.mark.parametrize("q_dtype,cache_dtype,h,hkv,dh,want", [
    (torch.float32, torch.float32, 8, 8, 64, "split"),     # Path A's shape
    (torch.float32, torch.int8, 8, 8, 64, "split"),        # path_q's
    (torch.float32, torch.float8_e4m3fn, 8, 8, 64, "split"),
    (torch.float32, torch.float32, 8, 1, 128, "split"),    # G 8, Dh 128
    (torch.float32, torch.int8, 6, 2, 128, "split"),       # G 3
    (torch.bfloat16, torch.bfloat16, 8, 8, 64, "ffma"),    # C6b: row max
    (torch.bfloat16, torch.int8, 8, 8, 64, "ffma"),
    (torch.float32, torch.float32, 8, 2, 80, "ffma"),      # Dh not 64/128
    (torch.float32, torch.float32, 8, 2, 32, "ffma"),
    (torch.float32, torch.float32, 16, 1, 64, "ffma"),     # G past 8
])
def test_b6_design_by_dtypes_and_shape(q_dtype, cache_dtype, h, hkv, dh,
                                       want):
    assert ba.b6_design(q_dtype, cache_dtype, h, hkv, dh) == want


def test_b6_design_wants_16_byte_aligned_pages():
    buf = torch.zeros(4 + 2 * 16 * 8 * 64)       # 8 bytes in: unaligned
    assert ba.b6_design(torch.float32, torch.float32, 8, 8, 64,
                        (buf[2:-2].view(2, 16, 8, 64),)) == "ffma"
    assert ba.b6_design(torch.float32, torch.float32, 8, 8, 64,
                        (buf[4:].view(2, 16, 8, 64),)) == "split"


@pytest.mark.parametrize("s,hkv,npg,lp", [
    (8, 8, 16, 128),      # Path A and path_q: L 2048 in pages of 128
    (8, 8, 128, 16),
    (8, 2, 18, 128),      # Path B's widths, paged
    (1, 1, 16, 128),      # one slot: every page its own split
    (1, 1, 512, 4),       # tiny pages: at least SPLIT_MIN_KEYS keys a split
    (64, 8, 16, 128),     # enough slots: no split
    (3, 8, 37, 7),        # ragged: NP prime, odd page length
    (2, 1, 200000, 1),    # more pages than MAX_SPLITS splits of 64 keys
])
def test_b6_splits_cover_every_page_once_and_fill_the_card(s, hkv, npg, lp):
    c = ba.b6_splits(s, hkv, npg, lp, H100_SMS)
    nsplit = -(-npg // c)
    assert 1 <= c <= ba.MAX_SPLIT_PAGES and nsplit <= ba.MAX_SPLITS
    pages = [p for z in range(nsplit) for p in range(z * c,
                                                    min(z * c + c, npg))]
    assert pages == list(range(npg))
    least = min(npg, -(-ba.SPLIT_MIN_KEYS // lp))
    if s * hkv * -(-npg // least) >= 2 * H100_SMS:
        assert s * hkv * nsplit >= 2 * H100_SMS
    # no more splits than that asks for: C is the largest that fills it
    if c < min(npg, ba.MAX_SPLIT_PAGES) and c > least:
        assert s * hkv * -(-npg // (c + 1)) < 2 * H100_SMS or \
            -(-npg // (c + 1)) == nsplit


def test_b6_splits_refuses_tables_past_its_limits():
    with pytest.raises(ValueError, match="pages a slot"):
        ba.b6_splits(1, 1, ba.MAX_SPLIT_PAGES * ba.MAX_SPLITS + 1, 16,
                     H100_SMS)


# the plain split-and-merge version (design 2's arithmetic) against JAX's
# paged kernel: float32 pages and int8 / e4m3 codes with scale rows
def _pool(rng, shape, kv):
    x = rng.standard_normal(shape).astype(np.float32)
    if kv is None:
        return torch.from_numpy(x), None, jnp.asarray(x), None
    codes, sc = quantize_kv(torch.from_numpy(x), kv)
    raw = codes.view(torch.uint8).numpy() if kv == torch.float8_e4m3fn \
        else codes.numpy()
    jcodes = jnp.asarray(raw.view(jnp.float8_e4m3fn)
                         if kv == torch.float8_e4m3fn else raw)
    return codes, sc, jcodes, jnp.asarray(sc.numpy())


@pytest.mark.parametrize("split_pages", [1, 2, 3])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv", [None, torch.int8, torch.float8_e4m3fn],
                         ids=["f32", "int8", "fp8"])
def test_plain_b6_split_merge_matches_jax_paged_kernel(kv, window,
                                                       split_pages):
    """Splits of `split_pages` pages, merged in split order, against JAX's
    paged kernel in interpret mode, at 1e-5: qpos 0 (one key; every
    other split lies past it), a range ending on a page boundary (15),
    slots sharing a prefix chain, unmapped entries holding page 0, a
    window; and a NaN query comes out NaN on both."""
    rng = np.random.default_rng([split_pages, 0 if window is None else 1])
    S, Lp, H, Hkv, Dh, P = 5, 8, 4, 2, 8, 14
    q = rng.standard_normal((S, H, Dh)).astype(np.float32)
    q[4] = np.nan
    ck, sk, jck, jsk = _pool(rng, (P, Lp, Hkv, Dh), kv)
    cv, sv, jcv, jsv = _pool(rng, (P, Lp, Hkv, Dh), kv)
    pt = np.array([[3, 7, 1, 0],
                   [3, 7, 9, 0],          # shares slot 0's first pages
                   [3, 5, 0, 0],
                   [11, 2, 6, 4],
                   [12, 13, 0, 0]], np.int32)
    qpos = np.array([0, 15, 20, 31, 9], np.int32)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jck, jcv, jnp.asarray(pt), jnp.asarray(qpos),
        window=window, interpret=True, scale_k=jsk, scale_v=jsv))
    got = ba.paged_decode_attention_plain(
        torch.from_numpy(q), ck, cv, torch.from_numpy(pt),
        torch.from_numpy(qpos), window=window, scale_k=sk, scale_v=sv,
        split_pages=split_pages).numpy()
    assert np.isnan(want[4]).all() and np.isnan(got[4]).all()
    np.testing.assert_allclose(got[:4], want[:4], **TOL)


def test_plain_b6_split_merge_gives_zeros_for_a_row_with_no_key():
    """Design 2 writes zeros where no key is visible (qpos -1), as
    design 1 does; the unsplit plain version leaves such rows as garbage
    by contract."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 2, 16, 4, 2, 8))
    pt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pages = k.reshape(4, 8, 2, 8)
    qpos = torch.tensor([-1, 12], dtype=torch.int32)
    got = ba.paged_decode_attention_plain(q, pages, pages, pt, qpos,
                                          split_pages=1)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = ba.paged_decode_attention_plain(q, pages, pages, pt, qpos)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), **TOL)
    with pytest.raises(ValueError, match="bfloat16"):
        ba.paged_decode_attention_plain(q.bfloat16(), pages.bfloat16(),
                                        pages.bfloat16(), pt, qpos,
                                        split_pages=1)


def test_b6_launch_counts_by_design_reset():
    """The counts of B5/B5q and B6/B6q by design (and B4's) reset, and
    calls on CPU tensors (the plain versions) leave them at 0."""
    ba.LAUNCHES_BY_DESIGN[("paged_decode_attention", "split")] = 3
    ba.LAUNCHES_BY_DESIGN[("paged_decode_attention_q", "ffma")] = 1
    ba.LAUNCHES_BY_DESIGN[("banded_decode_attention", "split")] = 2
    ba.LAUNCHES_BY_DESIGN[("banded_decode_attention_q", "ffma")] = 5
    ba.reset_counts()
    assert set(ba.LAUNCHES_BY_DESIGN.values()) == {0}
    assert set(ba.LAUNCHES_BY_DESIGN) == {
        (k, d) for k in ("paged_decode_attention", "paged_decode_attention_q",
                         "banded_decode_attention",
                         "banded_decode_attention_q")
        for d in ("ffma", "split")} | {
        ("banded_attention", d) for d in ("ffma", "folded")}
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 2, 16, 4, 2, 64))
    pos = torch.tensor([3, 12], dtype=torch.int32)
    ba.banded_decode_attention(q, k, v, pos, pos, window=8, rolling=True)
    ba.banded_decode_attention(q, k, v, pos, pos, design="split")
    assert set(ba.LAUNCHES_BY_DESIGN.values()) == {0}
    assert set(ba.LAUNCHES.values()) == {0}


# ------------------------------------- B5/B5q design 2: choice and splits
@pytest.mark.parametrize("q_dtype,cache_dtype,h,hkv,dh,want", [
    (torch.float32, torch.float32, 8, 2, 64, "split"),     # Path B's shape
    (torch.float32, torch.int8, 8, 2, 64, "split"),        # path_q's
    (torch.float32, torch.float8_e4m3fn, 8, 2, 64, "split"),
    (torch.float32, torch.float32, 8, 1, 128, "split"),    # G 8, Dh 128
    (torch.float32, torch.int8, 6, 2, 128, "split"),       # G 3
    (torch.bfloat16, torch.bfloat16, 8, 2, 64, "ffma"),    # C6b: row max
    (torch.bfloat16, torch.int8, 8, 2, 64, "ffma"),
    (torch.float32, torch.float32, 8, 2, 80, "ffma"),      # Dh not 64/128
    (torch.float32, torch.float32, 8, 2, 32, "ffma"),
    (torch.float32, torch.float32, 16, 1, 64, "ffma"),     # G past 8
])
def test_b5_design_by_dtypes_and_shape(q_dtype, cache_dtype, h, hkv, dh,
                                       want):
    assert ba.b5_design(q_dtype, cache_dtype, h, hkv, dh) == want
    buf = torch.zeros(4 + 2 * 16 * hkv * dh)     # 8 bytes in: unaligned
    assert ba.b5_design(q_dtype, cache_dtype, h, hkv, dh,
                        (buf[2:-2].view(2, 16, hkv, dh),)) == "ffma"


# (S, Hkv, L, window, tile keys, C, NSPLIT) on an H100's 132 SMs
B5_SPLITS = [
    (8, 2, 2303, 256, 32, 64, 5),      # Path B: the float32 ring
    (8, 2, 2303, 256, 128, 128, 3),    # path_q: 1-byte codes, a tile each
    (8, 2, 2048, None, 32, 121, 17),   # linear, no window: L / C blocks
    (8, 2, 2048, 256, 32, 64, 5),      # linear with Path B's window
    (1, 1, 2048, None, 32, 64, 32),    # one slot: SPLIT_MIN_KEYS a split
    (64, 8, 2048, 256, 32, 256, 2),    # enough slots: one chunk, + 1
    (8, 8, 37, 6, 32, 6, 2),           # a window under a tile
    (2, 1, 200000, None, 32, 1516, 132),   # a long cache: 2 x 132 blocks
]


@pytest.mark.parametrize("s,hkv,L,window,tile,c,nsplit", B5_SPLITS)
def test_b5_splits_by_shape(s, hkv, L, window, tile, c, nsplit):
    got_c, got_n = ba.b5_splits(s, hkv, L, window, H100_SMS, tile)
    assert (got_c, got_n) == (c, nsplit)
    assert got_n <= ba.MAX_SPLITS
    least = min(L if window is None else min(window, L),
                max(ba.SPLIT_MIN_KEYS, tile))
    if s * hkv * got_n < 2 * H100_SMS:
        assert got_c == least or got_n == ba.MAX_SPLITS


def test_split_tile_keys_are_one_16_kb_tile():
    assert ba.split_tile_keys(64, torch.float32) == 32
    assert ba.split_tile_keys(64, torch.int8) == 128
    assert ba.split_tile_keys(64, torch.float8_e4m3fn) == 128
    assert ba.split_tile_keys(128, torch.float32) == 16


@pytest.mark.parametrize("s,hkv,L,window,tile,c,nsplit", B5_SPLITS[:5] + [
    (4, 1, 23, 9, 32, 9, 3), (4, 1, 23, 40, 32, 23, 2)])
def test_b5_splits_cover_every_visible_position_once(s, hkv, L, window,
                                                      tile, c, nsplit):
    """Blocks z < NSPLIT own chunk lo // C + z of a slot's positions; the
    live ones (those meeting [lo, hi]) hold every visible position once,
    in order, whatever qpos and end (a ring read across its wrap, end
    ahead of qpos, qpos 0, -1), and their ring slots are distinct."""
    c, nsplit = ba.b5_splits(s, hkv, L, window, H100_SMS, tile)
    rng = np.random.default_rng(L)
    qpos = np.concatenate([[0, -1, L - 1, L, 3 * L + 1],
                           rng.integers(0, 4 * L, 40)])
    for rolling in ((False, True) if window else (False,)):
        end = qpos + (rng.integers(0, 5, qpos.size) if rolling else 0)
        lo, hi = ba.decode_range(torch.from_numpy(qpos),
                                 torch.from_numpy(end), L, window, rolling)
        vis = ba.visibility(torch.from_numpy(qpos), torch.from_numpy(end),
                            L, window, rolling)
        for i in range(qpos.size):
            a, b = int(lo[i]), int(hi[i])
            want = list(range(a, b + 1))
            got = []
            for z in range(nsplit):
                c0 = (a // c + z) * c
                got += list(range(max(a, c0), min(b, c0 + c - 1) + 1))
            assert got == want
            slots = [p % L for p in got]
            assert len(set(slots)) == len(slots)
            # the same set as the held-index rule
            assert sorted(slots) == vis[i].nonzero().flatten().tolist()


def _slot_pool(rng, shape, kv):
    """`_pool` for the slot pool: torch codes and scales, JAX's."""
    return _pool(rng, shape, kv)


@pytest.mark.parametrize("split_keys", [3, 8, 64])
@pytest.mark.parametrize("mode,window,rolling", MODES,
                         ids=[m[0] for m in MODES])
@pytest.mark.parametrize("kv", [None, torch.int8, torch.float8_e4m3fn],
                         ids=["f32", "int8", "fp8"])
def test_plain_b5_split_merge_matches_jax_kernel(kv, mode, window, rolling,
                                                 split_keys):
    """Design 2's arithmetic (`decode_attention_plain(split_keys=C)`: the
    chunks of C positions aligned to multiples of C, merged in order)
    against JAX's slot-pool kernel in interpret mode, at 1e-5: linear,
    windowed and rolling caches (the ring wrapped, end ahead of qpos on
    one slot), float32 caches and int8 / e4m3 codes with scale rows; a
    NaN query comes out NaN on both."""
    rng = np.random.default_rng([split_keys, len(mode)])
    S, L, H, Hkv, Dh = 6, 24, 4, 2, 8
    q = rng.standard_normal((S, H, Dh)).astype(np.float32)
    q[5] = np.nan
    ck, sk, jck, jsk = _slot_pool(rng, (S, L, Hkv, Dh), kv)
    cv, sv, jcv, jsv = _slot_pool(rng, (S, L, Hkv, Dh), kv)
    if rolling:
        qpos = np.array([0, 3, 23, 24, 37, 90], np.int32)
        end = qpos + np.array([0, 2, 0, 5, 0, 0], np.int32)
    else:
        qpos = np.array([0, 3, 7, 12, 23, 20], np.int32)
        end = qpos.copy()
    want = np.asarray(jax_banded_decode(
        jnp.asarray(q), jck, jcv, jnp.asarray(qpos), jnp.asarray(end),
        window=window, rolling=rolling, block_l=8, interpret=True,
        scale_k=jsk, scale_v=jsv))
    got = ba.decode_attention_plain(
        torch.from_numpy(q), ck, cv, torch.from_numpy(qpos),
        torch.from_numpy(end), window, rolling, scale_k=sk, scale_v=sv,
        split_keys=split_keys).numpy()
    assert np.isnan(want[5]).all() and np.isnan(got[5]).all()
    np.testing.assert_allclose(got[:5], want[:5], **TOL)


def test_plain_b5_split_merge_gives_zeros_for_a_row_with_no_key():
    """Design 2 writes zeros where no key is visible (end -1 on the
    ring), as design 1 does; the unsplit plain version leaves such rows
    as garbage by contract."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 2, 16, 4, 2, 8))
    qpos = torch.tensor([0, 20], dtype=torch.int32)
    end = torch.tensor([-1, 20], dtype=torch.int32)
    got = ba.decode_attention_plain(q, k, v, qpos, end, 6, True,
                                    split_keys=4)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = ba.decode_attention_plain(q, k, v, qpos, end, 6, True)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), **TOL)
    with pytest.raises(ValueError, match="bfloat16"):
        ba.decode_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  qpos, end, 6, True, split_keys=4)
