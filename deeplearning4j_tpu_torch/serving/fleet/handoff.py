"""KV page handoff: serialize a replica's warm prefix pages, install them
into another replica's paged pool (port of
`deeplearning4j_tpu/serving/fleet/handoff.py`, wire format
"kv-handoff-v1").

Wire format: every page is a dict of leaf entries keyed by the carry-tree
leaf path ("layer2_transformerencoderblock/attn/cache_k"), each entry
`{shape, dtype, data}` with the raw page bytes base64-encoded AT THE
STORED DTYPE. int8/fp8 pages ship as quantized codes plus their in-page
float32 scale rows (`scale_k`/`scale_v` are leaves like any other): a
handoff never dequantizes, and the importer refuses any dtype that does
not match its pool. `dtype` is numpy's name of the leaf's dtype
(`serving/kv_pool.DTYPE_NAMES`: "float32", "bfloat16", "int8",
"float8_e4m3fn", ...), and the bytes are the tensor's own in C order, so
a payload written by the JAX package installs here and the reverse; the
port maps the names to torch dtypes itself and needs no `ml_dtypes`.

Export and install each run under the donor's / recipient's pool lock
as ONE critical section, the serialization point of admission and decode
windows, so a handoff never sees or leaves a half-written page. The
export's device-to-host read is a host sync by nature; it is on the
handoff path, never inside a replica's decode window.
"""

from __future__ import annotations

import base64
from typing import Optional

import torch

from deeplearning4j_tpu_torch.serving.kv_pool import DTYPE_NAMES

FORMAT = "kv-handoff-v1"

_WIRE_DTYPES = {name: dt for dt, name in DTYPE_NAMES.items()}


class HandoffError(ValueError):
    """A handoff payload is malformed or incompatible with the recipient
    pool (dtype or page-geometry mismatch, unknown format)."""


def _leaves_to_wire(leaves: dict) -> dict:
    out = {}
    for key, t in leaves.items():
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        out[key] = {"shape": list(t.shape), "dtype": DTYPE_NAMES[t.dtype],
                    "data": base64.b64encode(raw).decode("ascii")}
    return out


def _wire_to_leaves(entry: dict) -> dict:
    out = {}
    for key, spec in entry.items():
        dt = _WIRE_DTYPES.get(spec["dtype"])
        if dt is None:
            raise HandoffError(
                f"leaf {key}: unknown dtype {spec['dtype']!r}")
        raw = bytearray(base64.b64decode(spec["data"]))
        shape = [int(n) for n in spec["shape"]]
        esize = torch.tensor([], dtype=dt).element_size()
        want = esize
        for n in shape:
            want *= n
        if len(raw) != want:
            raise HandoffError(
                f"leaf {key}: {len(raw)} bytes for shape {shape} of "
                f"{spec['dtype']}")
        flat = (torch.frombuffer(raw, dtype=torch.uint8) if raw
                else torch.empty(0, dtype=torch.uint8))
        out[key] = flat.view(dt).reshape(shape)
    return out


def payload_bytes(payload: dict) -> int:
    """Decoded KV bytes a payload carries (metrics, not wire size)."""
    n = 0
    for page in payload.get("pages", []):
        for spec in page.values():
            n += (len(spec["data"]) * 3) // 4
    return n


def export_prefix(pool, cache, tokens, *, model: str = "") -> Optional[dict]:
    """Serialize the longest cached prefix of `tokens` from this replica's
    radix index. Returns the handoff payload, or None when nothing is
    cached. One pool-lock critical section: the match, the page read-back
    (one device-to-host copy for every page) and the LRU refresh are
    atomic with respect to admission, eviction and decode windows."""
    toks = [int(t) for t in tokens]
    with pool.lock():
        cached_len, full_pages, partial = cache.match(toks)
        if cached_len <= 0:
            return None
        pages = list(full_pages)
        partial_tokens = 0
        if partial is not None:
            pages.append(partial[0])
            partial_tokens = int(partial[1])
        wire_pages = [_leaves_to_wire(p)
                      for p in pool.export_pages_locked(pages)]
    return {"format": FORMAT,
            "model": model or pool.model,
            "kv_dtype": pool.kv_dtype,
            "page_len": pool.page_len,
            "cached_len": int(cached_len),
            "tokens": toks[:cached_len],
            "full_pages": len(full_pages),
            "partial_tokens": partial_tokens,
            "pages": wire_pages}


def install_prefix(pool, cache, payload: dict) -> int:
    """Install a handoff payload into this replica's pool and index it in
    the radix, so the next admission's `match()` finds the warm stem.
    Returns the cached token length now resident. Fresh pages are
    allocated (evicting cold cache-only chains first if the free list is
    short), written in place by `import_page_locked`, adopted by the
    radix insert, and the importer's own references dropped: a page the
    index declined (its chunk was cached already) returns straight to the
    free list, so a duplicate handoff leaks nothing."""
    if payload.get("format") != FORMAT:
        raise HandoffError(
            f"unknown handoff format {payload.get('format')!r}")
    if int(payload["page_len"]) != int(pool.page_len or 0):
        raise HandoffError(
            f"page_len mismatch: payload {payload['page_len']}, "
            f"pool {pool.page_len}")
    if payload["kv_dtype"] != pool.kv_dtype:
        raise HandoffError(
            f"kv_dtype mismatch: payload {payload['kv_dtype']!r}, pool "
            f"{pool.kv_dtype!r} — quantized bytes only install into an "
            f"identical-dtype pool (no dequant round-trip)")
    tokens = [int(t) for t in payload["tokens"]]
    cached_len = int(payload["cached_len"])
    if len(tokens) != cached_len:
        raise HandoffError(
            f"payload carries {len(tokens)} tokens for cached_len "
            f"{cached_len}")
    Lp = int(payload["page_len"])
    n_full = int(payload["full_pages"])
    n_partial = 1 if int(payload["partial_tokens"]) else 0
    want = n_full * Lp + int(payload["partial_tokens"])
    if want != cached_len or len(payload["pages"]) != n_full + n_partial:
        raise HandoffError(
            f"page accounting does not cover the tokens: {n_full} full "
            f"+ {payload['partial_tokens']} partial vs cached_len "
            f"{cached_len} ({len(payload['pages'])} pages shipped)")
    leaves = [_wire_to_leaves(p) for p in payload["pages"]]
    n = len(leaves)
    with pool.lock():
        short = n - pool.pages_free_locked()
        if short > 0:
            cache.evict(short)
        fresh = pool.page_alloc_locked(n)   # raises when still short
        try:
            for page, lv in zip(fresh, leaves):
                pool.import_page_locked(page, lv)
            cache.insert(tokens, fresh)
        finally:
            # the index holds its own references now; ours were only for
            # the install. Unadopted pages drop to refcount 0 here.
            for p in fresh:
                pool.page_unref_locked(p)
    return cached_len
