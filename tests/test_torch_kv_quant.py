"""Quantized KV storage in the PyTorch port against the JAX package, on
the CPU: the kv_dtype policy (fp8 falls back to int8 where e4m3 is not
native), the int8/e4m3 carries with their float32 scale rows, the
lockstep refusal, quantize-on-write and dequantize-on-read through
`_decode`, the plain versions of the scale-row decode kernels B5q and
B6q against JAX's Pallas kernels in interpret mode, and the pool: slot
hygiene under reuse, its accounting, the prefix cache's copy-on-write,
and the session manager's greedy streams.

Tolerances, each with its reason: int8 codes bit-equal and e4m3 codes
equal as bytes (the same float32 division, then round half to even in
both); scale rows within two float32 ulps, 2^-22 relative (K and V
come out of matrix products that sum in another order, so a row's amax
may differ in its last bit, and the division by qmax rounds once
more); attention and layer outputs within 1e-5
(float32 sums in another order)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers.attention import (
    MultiHeadAttention as JaxMHA,
)
from deeplearning4j_tpu.ops.banded_attention import (
    banded_decode_attention as jax_b5, paged_decode_attention as jax_b6,
)
from deeplearning4j_tpu.ops.kernel_defaults import (
    kv_dtype_policy as jax_kv_policy,
)
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTGT,
)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv
from deeplearning4j_tpu_torch.observe import MetricsRegistry
from deeplearning4j_tpu_torch.ops import banded_attention as ba
from deeplearning4j_tpu_torch.ops import kernel_defaults as kd
from deeplearning4j_tpu_torch.serving import KVSlotPool

V = 256
TOL = dict(rtol=1e-5, atol=1e-5)
KV = {"int8": (torch.int8, jnp.int8),
      "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_np(x):
    """A port tensor as numpy, e4m3 as JAX's e4m3 numpy dtype."""
    if x.dtype == torch.float8_e4m3fn:
        return x.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    return x.numpy()


def _bytes(a):
    """Raw bytes of a port tensor or a JAX/numpy array, for bit-equality."""
    if isinstance(a, torch.Tensor):
        a = _to_np(a)
    return np.asarray(a).view(np.uint8)


# ---------------------------------------------------------------- policy
@pytest.mark.parametrize("kind", [None, "native", "int8", "fp8", "int4"])
def test_kv_dtype_policy_matches_jax_on_the_cpu(kind, monkeypatch):
    monkeypatch.delenv("DL4J_TPU_KV_DTYPE", raising=False)
    if kind == "int4":
        with pytest.raises(ValueError, match="unknown kv_dtype"):
            jax_kv_policy(kind, record=False)
        with pytest.raises(ValueError, match="unknown kv_dtype"):
            kd.kv_dtype_policy(kind, device="cpu", record=False)
        return
    want = jax_kv_policy(kind, record=False)
    got = kd.kv_dtype_policy(kind, device="cpu", record=False)
    assert got.kind == want.kind
    if kind == "fp8":
        assert got.kind == "int8" and "e4m3" in got.reason


def test_fp8_is_kept_only_where_e4m3_is_native():
    assert not kd.fp8_capable("cpu")
    want = "fp8" if kd.fp8_capable("cuda") else "int8"
    assert kd.kv_dtype_policy("fp8", device="cuda",
                              record=False).kind == want


# --------------------------------------------------------------- carries
def _mha_pair(**lkw):
    kw = dict(n_in=16, n_out=16, num_heads=4, num_kv_heads=2, causal=True,
              rope=True, max_cache=16, weight_init="xavier",
              activation="identity", **lkw)
    jl = JaxMHA(**kw)
    params, _ = jl.init_params(jax.random.PRNGKey(5),
                               JaxInputType.recurrent(16, 4))
    pp = {k: _t(np.asarray(v)) for k, v in params.items()}
    return jl, params, MultiHeadAttention(**kw), pp


@pytest.mark.parametrize("page_len", [None, 4], ids=["slots", "paged"])
@pytest.mark.parametrize("kv", sorted(KV))
def test_quantized_carries_match_jax(kv, page_len):
    jl, _, pl_, _ = _mha_pair()
    ckw = {} if page_len is None else dict(page_len=page_len, pages=14)
    jc = jl.decode_carry(3, jnp.float32, per_slot=True, kv_dtype=kv, **ckw)
    pc = pl_.decode_carry(3, torch.float32, per_slot=True, kv_dtype=kv,
                          **ckw)
    assert list(pc) == list(jc)
    for key in jc:
        assert tuple(pc[key].shape) == tuple(jc[key].shape), key
        assert _to_np(pc[key]).dtype == np.asarray(jc[key]).dtype, key
    assert pc["cache_k"].dtype == KV[kv][0]
    assert pc["scale_k"].dtype == torch.float32


def test_lockstep_quantized_carry_is_refused():
    _, _, pl_, _ = _mha_pair()
    with pytest.raises(ValueError, match="per_slot"):
        pl_.decode_carry(2, per_slot=False, kv_dtype="int8")
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        pl_.decode_carry(2, kv_dtype="int4")


LAYOUTS = [("linear", dict(), None),
           ("rolling", dict(window=5, rolling_cache=True), None),
           ("paged", dict(), 4)]


@pytest.mark.parametrize("layout,lkw,page_len", LAYOUTS,
                         ids=[l[0] for l in LAYOUTS])
@pytest.mark.parametrize("kv", sorted(KV))
def test_quantized_decode_matches_jax(kv, layout, lkw, page_len):
    """Padded prefill chunks with an inactive lane, then single-token
    steps: outputs, codes, scale rows and positions against JAX."""
    B = 3
    jl, params, pl_, pp = _mha_pair(**lkw)
    ckw = {} if page_len is None else dict(page_len=page_len, pages=14)
    jst = jl.decode_carry(B, jnp.float32, per_slot=True, kv_dtype=kv, **ckw)
    pst = pl_.decode_carry(B, torch.float32, per_slot=True, kv_dtype=kv,
                           **ckw)
    if page_len is not None:
        pt = np.array([[0, 5, 9, 2], [7, 1, 11, 4], [3, 13, 0, 0]],
                      np.int32)
        jst = dict(jst, page_table=jnp.asarray(pt))
        pst["page_table"].copy_(_t(pt))
    rng = np.random.default_rng(7)
    chunks = [(4, [[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]]),
              (4, [[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 0]]),
              (1, [[1], [0], [1]]),
              (1, [[1], [1], [1]]),
              (1, [[1], [1], [1]])]
    for T, m in chunks:
        x = rng.standard_normal((B, T, 16)).astype(np.float32)
        m = np.asarray(m, np.float32)
        yj, jst = jl.apply(params, jnp.asarray(x), state=jst,
                           mask=jnp.asarray(m))
        yp, pst = pl_.apply(pp, _t(x), state=pst, mask=_t(m))
        valid = m > 0
        np.testing.assert_allclose(yp.numpy()[valid],
                                   np.asarray(yj)[valid], **TOL)
        np.testing.assert_array_equal(pst["pos"].numpy(),
                                      np.asarray(jst["pos"]))
        for key in ("cache_k", "cache_v"):
            np.testing.assert_array_equal(_bytes(pst[key]),
                                          _bytes(jst[key]), err_msg=key)
        for key in ("scale_k", "scale_v"):
            np.testing.assert_allclose(pst[key].numpy(),
                                       np.asarray(jst[key]), rtol=2 ** -22,
                                       atol=0, err_msg=key)


@pytest.mark.parametrize("kv", sorted(KV))
def test_quantize_keeps_zero_rows_finite_and_saturates_the_range(kv):
    x = torch.zeros(2, 3, 8)
    x[0, 1] = torch.linspace(-3, 5, 8)
    codes, sc = quantize_kv(x, KV[kv][0])
    assert sc[1, 0] == 1.0 and sc[0, 1] == 5.0 / (127 if kv == "int8"
                                                   else 448)
    back = codes.float() * sc[..., None]
    assert torch.isfinite(back).all()
    assert back[0, 1].abs().max() == 5.0
    np.testing.assert_allclose(back.numpy(), x.numpy(),
                               atol=5.0 / (254 if kv == "int8" else 16))


# ------------------------------------------------------- plain B5q / B6q
def _quantized(rng, shape, kv):
    codes, sc = quantize_kv(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)), KV[kv][0])
    return codes, sc


MODES = [("linear", None, False), ("window", 4, False),
         ("rolling", 4, True)]


@pytest.mark.parametrize("mode,window,rolling", MODES,
                         ids=[m[0] for m in MODES])
@pytest.mark.parametrize("kv", sorted(KV))
def test_plain_b5q_matches_jax_kernel(kv, mode, window, rolling):
    rng = np.random.default_rng(11)
    s, l, h, hkv, dh = 4, 8, 4, 2, 8
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    ck, sk = _quantized(rng, (s, l, hkv, dh), kv)
    cv, sv = _quantized(rng, (s, l, hkv, dh), kv)
    qpos = np.array([1, 3, 9, 15] if rolling else [0, 3, 5, 7], np.int32)
    want = np.asarray(jax_b5(
        jnp.asarray(q), jnp.asarray(_to_np(ck)), jnp.asarray(_to_np(cv)),
        jnp.asarray(qpos), jnp.asarray(qpos), window=window,
        rolling=rolling, block_l=4, interpret=True,
        scale_k=jnp.asarray(sk.numpy()), scale_v=jnp.asarray(sv.numpy())))
    ba.reset_counts()
    got = ba.banded_decode_attention(_t(q), ck, cv, _t(qpos), _t(qpos),
                                     window=window, rolling=rolling,
                                     scale_k=sk, scale_v=sv)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not any(ba.LAUNCHES.values())


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv", sorted(KV))
def test_plain_b6q_matches_jax_kernel(kv, window):
    rng = np.random.default_rng(12)
    s, npg, lp, h, hkv, dh = 3, 4, 8, 4, 2, 8
    p = s * npg
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    ck, sk = _quantized(rng, (p, lp, hkv, dh), kv)
    cv, sv = _quantized(rng, (p, lp, hkv, dh), kv)
    pt = rng.permutation(p).reshape(s, npg).astype(np.int32)
    pt[1, :2] = pt[0, :2]                      # a shared prefix
    qpos = np.array([0, 13, 31], np.int32)
    want = np.asarray(jax_b6(
        jnp.asarray(q), jnp.asarray(_to_np(ck)), jnp.asarray(_to_np(cv)),
        jnp.asarray(pt), jnp.asarray(qpos), window=window, interpret=True,
        scale_k=jnp.asarray(sk.numpy()), scale_v=jnp.asarray(sv.numpy())))
    got = ba.paged_decode_attention(_t(q), ck, cv, _t(pt), _t(qpos),
                                    window=window, scale_k=sk, scale_v=sv)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrappers_check_scale_rows():
    q = torch.zeros(2, 4, 8)
    ck = torch.zeros(2, 8, 2, 8, dtype=torch.int8)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="need scale rows"):
        ba.banded_decode_attention(q, ck, ck, pos, pos)
    with pytest.raises(ValueError, match="take no scale rows"):
        ba.banded_decode_attention(q, ck.float(), ck.float(), pos, pos,
                                   scale_k=torch.ones(2, 8, 2),
                                   scale_v=torch.ones(2, 8, 2))
    with pytest.raises(ValueError, match=r"\[N, L, Hkv\]"):
        ba.banded_decode_attention(q, ck, ck, pos, pos,
                                   scale_k=torch.ones(2, 8),
                                   scale_v=torch.ones(2, 8))


# ------------------------------------------------------------- the pool
NETS = {
    # learned positions, layer norm, GELU: prefix cache on (paged pool)
    "paged": (dict(), 8),
    # RoPE, RMSNorm, SwiGLU, GQA 4:2, window 6 on a rolling ring (L 37)
    "rolling": (dict(pos_encoding="rope", norm="rms",
                     ffn_activation="swiglu", num_kv_heads=2, window=6,
                     rolling_cache=True), None),
}


@functools.lru_cache(maxsize=None)
def _build(name):
    kw, page_len = NETS[name]
    jconf = JaxTGT(input_shape=(32, 1), d_model=32, num_heads=4,
                   num_blocks=2, **kw).conf()
    jnet = JaxNet(jconf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    params_from_numpy(pnet, jax.tree_util.tree_map(np.asarray,
                                                   jnet.params_tree))
    return page_len, jnet, pnet


def _run_slot(pool, slot, toks):
    """Feed `toks` one at a time through `slot` (the other lanes idle)."""
    outs = []
    for tok in toks:
        x = np.zeros((pool.slots, 1, 1), np.float32)
        x[slot, 0, 0] = tok
        act = np.zeros((pool.slots,), bool)
        act[slot] = True
        out, new = pool.net.session_step(x, pool.carries, active=act,
                                         valid=act[:, None].astype(
                                             np.float32))
        with pool.lock():
            pool.swap_carries(new)
        outs.append(out[slot, 0].clone())
    return torch.stack(outs)


def test_freed_int8_slot_never_leaks_into_its_next_tenant():
    """Poison a freed slot's int8 caches and scale rows with finite
    garbage, reuse it past the ring's wrap: the outputs equal a clean
    pool's bit for bit."""
    _, _, pnet = _build("rolling")
    rng = np.random.default_rng(7)
    session_a, session_b = rng.integers(0, V, 40), rng.integers(0, V, 12)
    pool = KVSlotPool(pnet, 2, kv_dtype="int8", metrics=MetricsRegistry())
    slot = pool.alloc()
    _run_slot(pool, slot, session_a)
    pool.free(slot)
    leaves = [c["attn"] for c in pool.carries.values() if "attn" in c]
    for attn in leaves:
        for key, a in attn.items():
            assert not a[slot].any(), f"freed slot's {key} not reset"
        attn["cache_k"][slot] = 127
        attn["cache_v"][slot] = 127
        attn["scale_k"][slot] = 7777.0
        attn["scale_v"][slot] = 7777.0
    assert pool.alloc() == slot
    got = _run_slot(pool, slot, session_b)
    assert torch.isfinite(got).all()
    clean = KVSlotPool(pnet, 2, kv_dtype="int8", metrics=MetricsRegistry())
    want = _run_slot(clean, clean.alloc(), session_b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kv", sorted(KV))
def test_pool_accounting_counts_the_scale_rows(kv):
    _, _, pnet = _build("rolling")
    q = KVSlotPool(pnet, 2, kv_dtype=kv, metrics=MetricsRegistry())
    n = KVSlotPool(pnet, 2, metrics=MetricsRegistry())
    dq, dn = q.describe(), n.describe()
    assert dq["kv_dtype"] == kv and dn["kv_dtype"] == "native"
    # 4 Dh / (Dh + 4) at Dh 8 on the caches, diluted by the positions
    assert dq["slots_per_chip_factor"] >= 2.0
    assert dn["slots_per_chip_factor"] == 1.0
    assert dn["slot_bytes"] > dq["slot_bytes"]
    L, hkv, dh = 37, 2, 8
    per_layer = 2 * L * hkv * dh + 2 * L * hkv * 4 + 4      # codes, scales
    assert dq["slot_bytes"] == 2 * per_layer


def test_page_copy_on_write_carries_the_scale_rows():
    page_len, _, pnet = _build("paged")
    pool = KVSlotPool(pnet, 2, kv_dtype="int8", page_len=page_len,
                      metrics=MetricsRegistry())
    attn = next(c["attn"] for c in pool.carries.values() if "attn" in c)
    attn["cache_k"][3] = 9
    attn["scale_k"][3] = 0.25
    attn["scale_v"][3] = 0.5
    with pool.lock():
        pool.copy_page_locked(3, 5)
    assert (attn["cache_k"][5] == 9).all()
    assert (attn["scale_k"][5] == 0.25).all()
    assert (attn["scale_v"][5] == 0.5).all()


def _serve(pkg, net, waves, *, kv_dtype, page_len=None, max_tokens=10):
    if pkg == "jax":
        from deeplearning4j_tpu.serving import (
            ContinuousBatchingScheduler, DecodeSessionManager,
            ModelRegistry, ServingStats,
        )
    else:
        from deeplearning4j_tpu_torch.serving import (
            ContinuousBatchingScheduler, DecodeSessionManager,
            ModelRegistry, ServingStats,
        )
    registry = ModelRegistry()
    registry.deploy("default", 1, net, warm=False)
    stats = ServingStats()
    sched = ContinuousBatchingScheduler(registry, stats, max_batch_size=8)
    mgr = DecodeSessionManager(registry, sched, "default", slots=4,
                               prefill_chunk=8, fused_k=4, kv_dtype=kv_dtype,
                               page_len=page_len, metrics=stats.registry)
    try:
        out = []
        for wave in waves:
            sessions = [mgr.open_session(p, max_tokens=max_tokens,
                                         greedy=True) for p in wave]
            out.append([s.result(timeout=120) for s in sessions])
        return out, mgr.snapshot()
    finally:
        sched.shutdown()
        registry.close()


def test_warm_int8_prefix_session_equals_cold():
    """A 20-token stem fills two pages and part of a third; the warm
    sessions share the full pages and fork the partial one by
    copy-on-write, scale rows included."""
    page_len, _, pnet = _build("paged")
    stem = np.random.default_rng(8).integers(0, V, 20)
    waves = [[stem], [stem, np.concatenate([stem, [5, 6]])]]
    ((cold,),), _ = _serve("torch", pnet, waves[:1], kv_dtype="int8",
                           page_len=page_len)
    ((w1,), (w2, _)), snap = _serve("torch", pnet, waves, kv_dtype="int8",
                                    page_len=page_len)
    assert w1 == cold and w2 == cold
    assert snap["prefix_cache"]["hits"] >= 2
    assert snap["slots"]["kv_dtype"] == "int8"


@pytest.mark.parametrize("name", sorted(NETS))
def test_int8_manager_streams_match_jax(name):
    page_len, jnet, pnet = _build(name)
    rng = np.random.default_rng(7)
    wave = [rng.integers(0, V, n) for n in (5, 11, 17, 3)]
    want, jsnap = _serve("jax", jnet, [wave], kv_dtype="int8",
                         page_len=page_len)
    got, psnap = _serve("torch", pnet, [wave], kv_dtype="int8",
                        page_len=page_len)
    assert got == want
    assert psnap["slots"]["kv_dtype"] == jsnap["slots"]["kv_dtype"] == "int8"


def test_fp8_request_serves_int8_on_the_cpu():
    """The snapshot's kv_dtype block reports what the pool holds."""
    page_len, _, pnet = _build("rolling")
    (streams,), snap = _serve("torch", pnet, [[np.arange(6)]],
                              kv_dtype="fp8", max_tokens=4)
    assert len(streams[0]) == 4
    assert snap["kv_dtype"]["kind"] == snap["slots"]["kv_dtype"] == "int8"
