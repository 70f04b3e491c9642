"""Stateful decode serving: per-request sessions over a shared KV slot
pool, stepped through the continuous-batching scheduler (port of
`deeplearning4j_tpu/serving/sessions.py`).

Each session owns a SLOT in a `KVSlotPool` (one batch row of the
[slots, ...] carry tree), and every step — prefill chunk or fused decode
window — is submitted to the `ContinuousBatchingScheduler` as a one-row
request against a dedicated `<model>@decode` endpoint. The scheduler
coalesces whatever rows are queued (sessions at different phases share a
dispatch), and the endpoint's `run_batch` runs at most two calls: one
`session_step` over the co-batched prefill chunks (its logits are never
read back), then one `session_decode_window` that advances every
decoding lane K tokens with sampling on the device. The only host read
of a dispatch is the window's packed [2, S, K] tokens and emit flags,
after the pool lock is released: K tokens per round-trip
(`decode_loop_policy` picks K).

Prefix cache: when `prefix_cache_policy` says "paged", the pool stores
KV in fixed-size pages behind per-slot page tables, and a radix index
(`prefix_cache.py`) maps prompt prefixes to refcounted shared page
chains. Admission matches the prompt stem, adopts the matched pages,
forks at most one partially-matched page (copy-on-write) and installs
the slot's table, all under the pool lock; prefill then RESUMES after
the cached prefix. Completed prefills are offered back to the index at
the first decode row. The single-token decode steps run the paged
decode kernel (B6) on the paged pool and the slot decode kernel (B5) on
the monolithic one.

Speculative decoding: with a DRAFT net wired in, `spec_decode_policy`
turns each window into draft-propose + target-verify: the draft proposes
`spec_k` tokens through its own window over a pool that mirrors the
target's slots (registered as `<model>@draft`), the target scores all of
them in one chunked forward, and accept/reject stays on the device
(`utils/sampling.spec_accept_lanes`). Rejected proposals are un-written
by rewinding per-slot positions, so both nets must be rewind-capable (no
recurrent carries, no rolling rings), and a speculating manager keeps the target off the
prefix cache (the draft must prefill every prompt token). Propose and
verify are one graph replay each; the one host read of a window is the
verify's packed [S, spec_k + 4] rows, after both pool locks are
released. Every acquirer takes the target pool's lock before the
draft's.

EOS: a lane stops AT its EOS token — the token is emitted, nothing
after it is.

Hot-swap: the manager subscribes to the registry's deploy hooks for its
model. In the "warm" phase it checks that the candidate can host the
live carry tree (else IncompatibleSessionSwapError, and the deploy rolls
back with the sessions untouched) and runs the candidate's session
calls once over the live pool with every lane inactive, which writes
nothing and captures the candidate's window graphs over the caches it
will use; in the "flipped" phase it rebinds the pool, so every live
session continues on the new weights (a recurrent net's h/c included).

Recurrent nets (an LSTM, GRU or SimpleRnn stack, one-hot or embedded
input) serve through the same seam: the pool holds each recurrent
layer's h/c rows beside any attention caches, a step's mask holds them
for padded and inactive lanes, and the windows write them back into the
pool's tensors. Their carries cannot rewind or be paged, so such a
manager runs with speculation and the prefix cache off.

Observe hooks: a session carries its request's TraceContext through
every resubmitted row; each dispatch records one `session.window` span
per traced row under that trace's `dispatch` span (phase, window,
tokens emitted, bucket, kernel), and a finished session a
`session.close` span. `session_open`, `session_close` and
`decode_sessions_migrated` (a hot-swap flip) are flight-recorder
events; TTFT and ITL observations carry the trace id as exemplar.

Prefill-only sessions (`open_prefill`, the fleet's prefill role) run the
prompt stem through chunked prefill, offer its pages to the radix index
and finish with no token generated; the fleet's handoff then exports the
warm stem (`serving/fleet/handoff.py`).

Not ported yet: the comms-monitor seams that wait for collectives (A6).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.observe import get_flight, reqtrace
from deeplearning4j_tpu_torch.ops.kernel_defaults import (
    decode_attention_policy, decode_loop_policy, kv_dtype_policy,
    prefix_cache_policy, spec_decode_policy,
)
from deeplearning4j_tpu_torch.serving.kv_pool import (
    IncompatibleSessionSwapError, KVSlotPool, SlotPoolExhaustedError,
    carry_layout,
)
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.serving.registry import ModelEntry
from deeplearning4j_tpu_torch.serving.scheduler import (
    DeadlineExceededError, SchedulerClosedError,
)
from deeplearning4j_tpu_torch.utils.sampling import (
    SamplingParams, lane_param_arrays,
)
from deeplearning4j_tpu_torch.utils.textgen import (
    _encode, _input_encoding, _resolve_net,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

_OUTCOMES = ("completed", "cancelled", "expired", "failed")


class DecodeSession:
    """One streaming generation: a slot, a cursor into the prompt, the
    sampling state, and a queue of token events the client drains."""

    def __init__(self, sid: str, slot: int, prompt: np.ndarray, *,
                 max_tokens: int, params: SamplingParams,
                 seed: Optional[int], deadline_ms: Optional[float],
                 eos_id: Optional[int], trace=None):
        self.id = sid
        self.slot = slot
        self.prompt = prompt
        # a sampled request's TraceContext rides every resubmitted row;
        # None on the sampled-off path
        self.trace = trace
        self.max_tokens = int(max_tokens)
        self.params = params
        # sampling runs on the device inside the window: token i of the
        # session draws from (its two seed words, counter i), so the
        # stream depends on the seed alone — not on K or co-batching
        seed = 0 if seed is None else int(seed)
        self.base_key = np.array(
            [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)
        self.eos_id = eos_id
        self.opened_at = time.monotonic()
        self.deadline = (None if deadline_ms is None
                         else self.opened_at + deadline_ms / 1000.0)
        self.generated: List[int] = []
        self.outcome: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.ttft_ms: Optional[float] = None
        self.done = threading.Event()
        self.cancelled = False
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._off = 0              # prompt tokens already submitted
        self._last_tok_at: Optional[float] = None
        self._finished = False     # guarded by the manager lock
        # speculative bookkeeping (manager-owned; the session has one row
        # in flight): how far the draft's position must rewind on window
        # entry, and the catch-up token (d_k) the draft never wrote when
        # the previous window accepted every draft
        self._spec_rewind = 0
        self._spec_pre_tok = 0
        self._spec_pre_valid = False
        # paged prefix-cache bookkeeping (manager-owned)
        self._pages: List[int] = []
        self._cached_len = 0
        self._prefix_inserted = False
        # the prefix generation at admission: after a hot-swap flip this
        # session's KV belongs to the old weights and is never indexed
        self._gen = 0
        # the fleet's prefill role: prefill the stem, index its pages and
        # finish without sampling (another replica decodes from them)
        self._prefill_only = False

    # -------------------------------------------------------- client API
    def stream(self, timeout: Optional[float] = None):
        """Yield token events as they arrive: `{"token", "index"}` per
        token, then exactly one terminal event (`{"done": ...}` or
        `{"error": ...}`). Raises queue.Empty after `timeout` seconds
        without an event."""
        while True:
            ev = self._events.get(timeout=timeout)
            yield ev
            if "done" in ev or "error" in ev:
                return

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the session finishes; returns the generated token
        ids, or raises the session's error."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"session {self.id} still running")
        if self.error is not None:
            raise self.error
        return list(self.generated)

    def cancel(self) -> None:
        """Request cancellation; honored at the next window boundary."""
        self.cancelled = True

    def remaining_ms(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return (self.deadline - time.monotonic()) * 1000.0

    def describe(self) -> dict:
        return {"id": self.id, "slot": self.slot,
                "prompt_len": int(self.prompt.size),
                "generated": len(self.generated),
                "max_tokens": self.max_tokens,
                "ttft_ms": self.ttft_ms,
                "outcome": self.outcome,
                "trace_id": (self.trace.trace_id
                             if self.trace is not None else None)}


class DecodeSessionManager:
    """Owns the slot pool, the `<model>@decode` endpoint, and the
    callback chain that steps every live session."""

    def __init__(self, registry, scheduler, model: str = "default", *,
                 slots: int = 4, prefill_chunk: int = 8,
                 fused_k: Optional[int] = None,
                 draft_net=None, spec_k: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 page_len: Optional[int] = None,
                 metrics=None, warm: bool = True):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        base = registry.get(model)      # KeyError if not deployed
        if not hasattr(base.net, "session_carries"):
            raise TypeError(
                f"decode sessions need a net with session_carries() "
                f"(MultiLayerNetwork); got {type(base.net).__name__}")
        self.registry = registry
        self.scheduler = scheduler
        self.model = model
        self.decode_name = f"{model}@decode"
        self.prefill_chunk = int(prefill_chunk)
        self.buckets = sorted({1, self.prefill_chunk})
        loop = decode_loop_policy(
            k=fused_k, capable=hasattr(base.net, "session_decode_window"))
        self.loop_kind = loop.kind
        self.fused_k = int(loop.k)
        self._loop_reason = loop.reason
        self._lock = threading.Lock()
        self._sessions: Dict[str, DecodeSession] = {}
        self._sid = itertools.count(1)
        self._seed_rng = np.random.default_rng()
        self._closed = False

        first, vocab = _resolve_net(base.net)
        self.vocab = int(vocab)
        self._encoding = _input_encoding(first)
        self._limit = base.net.decode_limit()

        kvp = kv_dtype_policy(kv_dtype, device=base.net.device)
        self.kv_dtype = kvp.kind
        self._kv_reason = kvp.reason

        # speculation needs a draft of the target's vocabulary, and both
        # nets must rewind their caches (no rolling rings)
        self.draft_net = draft_net
        spec_capable = False
        if draft_net is not None and \
                hasattr(draft_net, "session_propose_window"):
            _, dv = _resolve_net(draft_net)
            spec_capable = (int(dv) == self.vocab
                            and base.net.spec_decode_capable()
                            and draft_net.spec_decode_capable())
        spec = spec_decode_policy(spec_k, capable=spec_capable)
        self.spec_enabled = spec.kind == "spec"
        self.spec_k = int(spec.k)
        self._spec_reason = spec.reason
        self.draft_name = f"{model}@draft" if self.spec_enabled else None

        mc = None
        for layer in getattr(base.net, "layers", ()):
            if hasattr(layer, "decode_carry") and \
                    hasattr(layer, "max_cache"):
                mc = int(layer.max_cache)
                break
        # the draft's mirrored pool prefills every prompt token, so a
        # speculating target cannot skip a cached prefix
        pcap = (mc is not None and base.net.prefix_cache_capable()
                and not self.spec_enabled)
        ppol = prefix_cache_policy(page_len, max_cache=mc, capable=pcap)
        self.prefix_enabled = ppol.kind == "paged"
        self.page_len = int(ppol.page_len)
        self._prefix_reason = ppol.reason

        from deeplearning4j_tpu_torch.observe import get_registry
        if metrics is None:
            metrics = get_registry()
        self.metrics = metrics
        if metrics is not get_registry():
            # mirror the policy verdicts onto a private server registry
            metrics.counter("kernel_dispatch_total", op="decode_loop",
                            impl=self.loop_kind).inc()
            metrics.counter("kernel_dispatch_total", op="spec_decode",
                            impl="spec" if self.spec_enabled
                            else "plain").inc()
            metrics.counter("kernel_dispatch_total", op="kv_dtype",
                            impl=self.kv_dtype).inc()
            metrics.counter("kernel_dispatch_total", op="prefix_cache",
                            impl="paged" if self.prefix_enabled
                            else "off").inc()
        self.pool = KVSlotPool(
            base.net, slots, model=model, metrics=metrics,
            kv_dtype=self.kv_dtype,
            page_len=self.page_len if self.prefix_enabled else None)
        self.prefix_cache = (PrefixCache(self.pool, metrics=metrics)
                             if self.prefix_enabled else None)
        # bumped (under the pool lock) at every hot-swap flip, with the
        # radix index flushed: a session admitted under an older
        # generation prefilled with the old weights and is never indexed
        self._prefix_gen = 0
        # the draft's pool: slot i belongs to the session holding the
        # target's slot i, so it is reset, never allocated or freed
        self.draft_pool = None
        if self.spec_enabled:
            self.draft_pool = KVSlotPool(
                draft_net, slots, model=self.draft_name, metrics=metrics,
                kv_dtype=self.kv_dtype)
        self._g_active = metrics.gauge("serving_sessions_active",
                                       model=model)
        self._c_opened = metrics.counter("serving_sessions_total",
                                         model=model, outcome="opened")
        self._c_out = {o: metrics.counter("serving_sessions_total",
                                          model=model, outcome=o)
                       for o in _OUTCOMES}
        self._c_tokens = metrics.counter("serving_decode_tokens_total",
                                         model=model)
        self._h_ttft = metrics.histogram("serving_ttft_ms", model=model)
        self._h_itl = metrics.histogram("serving_itl_ms", model=model)
        self._c_disp = metrics.counter("serving_decode_dispatches_total",
                                       model=model)
        self._c_rows = metrics.counter(
            "serving_decode_dispatch_rows_total", model=model)
        self._c_shared = metrics.counter(
            "serving_decode_shared_dispatches_total", model=model)
        self._c_windows = metrics.counter(
            "serving_decode_windows_total", model=model)
        self._c_window_tokens = metrics.counter(
            "serving_decode_window_tokens_total", model=model)
        # accepted / draft tokens is the acceptance rate; the histogram
        # holds each lane-window's share
        self._c_draft_toks = metrics.counter("draft_tokens_total",
                                             model=model)
        self._c_accepted = metrics.counter("accepted_tokens_total",
                                           model=model)
        self._h_accept = metrics.histogram(
            "serving_spec_acceptance_rate", model=model)

        self.entry = registry.register_entry(
            self.decode_name,
            ModelEntry(self.decode_name, getattr(base, "version", None),
                       base.net, runner=self))
        if self.spec_enabled:
            registry.register_entry(
                self.draft_name,
                ModelEntry(self.draft_name, getattr(base, "version", None),
                           draft_net, runner=self))
        registry.add_deploy_hook(model, self._deploy_hook)
        self._kernel_policy_rows = self._kernel_policy(base.net)
        if warm:
            self.warmup()

    # ------------------------------------------------------------ warmup
    def _feat_dim(self) -> int:
        return 1 if self._encoding == "ids" else self.vocab

    def warmup(self) -> None:
        """Run the pool's net once through every call a dispatch can make
        (see `_warm`): the first dispatch pays no one-time costs (kernel
        build, allocator growth, window graph captures)."""
        self._warm(self.pool.net)

    def _warm(self, net) -> None:
        """One all-lanes-inactive step per prefill bucket and one
        all-lanes-inactive window (the plain window, or the draft's
        prefill buckets, propose and verify when speculating) of `net`
        over the live pools, under their locks. Inactive lanes write
        nothing, so the pools are unchanged; the window graphs are
        captured over the caches the live windows use."""
        S, F = self.pool.slots, self._feat_dim()
        act = np.zeros((S,), bool)
        knobs = dict(temperature=np.ones((S,), np.float32),
                     top_k=np.full((S,), self.vocab, np.int32),
                     top_p=np.ones((S,), np.float32),
                     greedy=np.ones((S,), bool),
                     keys=np.zeros((S, 2), np.uint32),
                     offsets=np.zeros((S,), np.int32))
        stop = dict(budgets=np.zeros((S,), np.int32),
                    eos_ids=np.full((S,), -1, np.int32))
        z = np.zeros((S,), np.int64)
        with self.pool.lock():
            carries = self.pool.carries
            for b in self.buckets:
                net.session_step(np.zeros((S, b, F), np.float32), carries,
                                 active=act,
                                 valid=np.zeros((S, b), np.float32))
            if not self.spec_enabled:
                out, _, _ = net.session_decode_window(
                    z, carries, active=act, k=self.fused_k, **knobs, **stop)
            else:
                with self.draft_pool.lock():
                    dnet, dcar = self.draft_pool.net, self.draft_pool.carries
                    for b in self.buckets:
                        dnet.session_step(np.zeros((S, b, F), np.float32),
                                          dcar, active=act,
                                          valid=np.zeros((S, b), np.float32))
                    d_toks, d_probs, _ = dnet.session_propose_window(
                        z, dcar, active=act, k=self.spec_k, rewind=z,
                        pre_tokens=z, pre_valid=act, **knobs)
                out, _ = net.session_verify_window(
                    z, carries, active=act, k=self.spec_k,
                    draft_tokens=d_toks, draft_probs=d_probs, **knobs,
                    **stop)
        out.cpu()       # warm-up barrier, before any traffic

    # ---------------------------------------------------------- sessions
    def open_session(self, prompt_ids, *, max_tokens: int = 16,
                     temperature: float = 1.0,
                     top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     greedy: bool = False, seed: Optional[int] = None,
                     deadline_ms: Optional[float] = None,
                     eos_id: Optional[int] = None,
                     alloc_timeout_s: float = 0.0,
                     trace=None,
                     prefill_only: bool = False) -> DecodeSession:
        """Admit one generation: claim a slot (SlotPoolExhaustedError ->
        503 upstream), check the token budget against the net's decode
        limit, and start the prefill -> decode callback chain. Returns
        immediately; consume via `stream()` / `result()`."""
        prompt = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt_ids must contain at least one token")
        if prompt.min() < 0 or prompt.max() >= self.vocab:
            raise ValueError(
                f"prompt token ids must be in [0, {self.vocab})")
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        params = SamplingParams(temperature=temperature, top_k=top_k,
                                top_p=top_p, greedy=greedy)
        # a verify writes spec_k + 1 entries past the confirmed position
        # before the cut snaps it back: the cache must leave that room
        head = (self.spec_k + 1) if self.spec_enabled else 0
        if self._limit is not None and \
                int(prompt.size) + int(max_tokens) + head > self._limit:
            raise ValueError(
                f"prompt ({prompt.size}) + max_tokens ({max_tokens})"
                f"{f' + spec headroom ({head})' if head else ''} "
                f"exceeds the decode budget of {self._limit} for this "
                f"net (non-rolling cache)")
        with self._lock:
            if self._closed:
                raise SchedulerClosedError("session manager is shut down")
            if seed is None:
                seed = int(self._seed_rng.integers(0, 2 ** 63))
        slot = self.pool.alloc(alloc_timeout_s)
        cached_len, pages, gen = 0, [], 0
        if self.prefix_enabled:
            try:
                with self.pool.lock():
                    gen = self._prefix_gen
                    cached_len, pages = self._admit_pages(
                        slot, prompt, int(max_tokens))
            except BaseException:
                self.pool.free(slot)
                raise
        sess = DecodeSession(
            f"s{next(self._sid):06d}", slot, prompt,
            max_tokens=max_tokens, params=params, seed=seed,
            deadline_ms=deadline_ms, eos_id=eos_id, trace=trace)
        sess._pages = pages
        sess._cached_len = cached_len
        sess._gen = gen
        sess._prefill_only = bool(prefill_only)
        # prefill resumes AFTER the cached prefix
        sess._off = cached_len
        with self._lock:
            self._sessions[sess.id] = sess
            n_active = len(self._sessions)
        self._c_opened.inc()
        self._g_active.set(n_active)
        get_flight().record("session_open", model=self.model,
                            session=sess.id, slot=slot,
                            prompt_len=int(prompt.size),
                            max_tokens=int(max_tokens))
        self._submit_next(sess)
        return sess

    def open_prefill(self, prompt_ids, *,
                     deadline_ms: Optional[float] = None,
                     alloc_timeout_s: float = 0.0,
                     trace=None) -> DecodeSession:
        """Admit a prefill-ONLY session (the fleet's prefill role): run
        the prompt stem through chunked prefill, offer the pages to the
        radix index, and finish with zero generated tokens. The warm stem
        is then exportable through the fleet handoff. Needs the prefix
        cache: without an index the prefilled pages would be unreachable
        the moment the slot frees."""
        if not self.prefix_enabled:
            raise ValueError(
                "prefill-only sessions require a paged pool with the "
                "prefix cache enabled (page_len=...)")
        return self.open_session(
            prompt_ids, max_tokens=1, greedy=True,
            deadline_ms=deadline_ms, alloc_timeout_s=alloc_timeout_s,
            trace=trace, prefill_only=True)

    def get_session(self, sid: str) -> Optional[DecodeSession]:
        with self._lock:
            return self._sessions.get(sid)

    def cancel(self, sid: str) -> bool:
        sess = self.get_session(sid)
        if sess is None:
            return False
        sess.cancel()
        return True

    # ----------------------------------------------- paged admission
    def _admit_pages(self, slot: int, prompt: np.ndarray, max_tokens: int):
        """All page bookkeeping of one admission, under the pool lock:
        match the prompt stem against the radix index, adopt the shared
        full pages by reference, fork (copy) at most ONE partially-matched
        page, allocate fresh pages for the rest of the token budget, and
        install the slot's page table + position. Returns
        `(cached_len, page_chain)`. Caller holds the pool lock."""
        Lp = self.pool.page_len
        stem = int(prompt.size) - 1
        cl, shared, partial = self.prefix_cache.match(prompt[:stem])
        # pin every matched page before the eviction pass below can run
        pinned = list(shared)
        if partial is not None:
            pinned.append(partial[0])
        for p in pinned:
            self.pool.page_ref_locked(p)
        fresh = []
        try:
            total = int(prompt.size) + max_tokens
            need = -(-total // Lp)      # ceil: whole session footprint
            n_fresh = need - len(shared)
            short = n_fresh - self.pool.pages_free_locked()
            if short > 0:
                self.prefix_cache.evict(short)
            if self.pool.pages_free_locked() < n_fresh:
                raise SlotPoolExhaustedError(
                    f"need {n_fresh} KV pages, "
                    f"{self.pool.pages_free_locked()} free after "
                    f"eviction")
            fresh = self.pool.page_alloc_locked(n_fresh)
            chain = list(shared) + fresh
            if partial is not None:
                src, _ = partial
                self.pool.copy_page_locked(src, chain[len(shared)])
                self.prefix_cache.note_cow_fork()
            self.pool.install_pages_locked(slot, chain, cl)
        except BaseException:
            for p in fresh:
                self.pool.page_unref_locked(p)
            for p in pinned:
                self.pool.page_unref_locked(p)
            raise
        if partial is not None:
            self.pool.page_unref_locked(partial[0])
        return cl, chain

    def _insert_prefix(self, sess: DecodeSession) -> None:
        """Offer a completed prefill to the radix index (once, at the
        session's first decode row). Best-effort: indexing is a
        performance optimization and must never take the session down."""
        stem = sess.prompt.size - 1
        if stem <= 0 or not sess._pages:
            return
        try:
            with self.pool.lock():
                if sess._gen != self._prefix_gen:
                    return      # old-weight KV: a flip happened since
                self.prefix_cache.insert(sess.prompt[:stem], sess._pages)
        except Exception:
            logger.exception("prefix-cache insert failed (session %s)",
                             sess.id)

    # --------------------------------------------------- stepping chain
    def _next_row(self, sess: DecodeSession) -> np.ndarray:
        """The session's next request row, [1, 3 + chunk]:
        [slot, phase, n_valid, tok_0..]. Phase 0 rows carry up to
        `chunk` prompt-STEM tokens; the phase 1 row carries the window's
        first input token (the last prompt token, then the previous
        window's last sample)."""
        row = np.zeros((1, 3 + self.prefill_chunk), np.float32)
        row[0, 0] = sess.slot
        stem = sess.prompt.size - 1
        if sess._off < stem:
            toks = sess.prompt[sess._off:min(stem, sess._off +
                                             self.prefill_chunk)]
            sess._off += toks.size
        else:
            if self.prefix_enabled and not sess._prefix_inserted:
                sess._prefix_inserted = True
                self._insert_prefix(sess)
            row[0, 1] = 1.0
            toks = np.asarray([sess.generated[-1] if sess.generated
                               else sess.prompt[-1]], np.int64)
        row[0, 2] = toks.size
        row[0, 3:3 + toks.size] = toks
        return row

    def _submit_next(self, sess: DecodeSession) -> None:
        with self._lock:
            if sess._finished:
                return
        rem = sess.remaining_ms()
        if rem is not None and rem <= 0:
            self._finish(sess, error=DeadlineExceededError(
                f"session {sess.id} deadline passed"))
            return
        if sess._prefill_only and sess._off >= sess.prompt.size - 1:
            # the fleet's prefill role: the stem is prefilled; index its
            # pages (the handoff exports them from the radix) and finish
            # without entering a decode window
            if self.prefix_enabled and not sess._prefix_inserted:
                sess._prefix_inserted = True
                self._insert_prefix(sess)
            self._finish(sess, outcome="completed")
            return
        row = self._next_row(sess)
        try:
            # explicit trace: resubmits run on scheduler worker threads,
            # where the edge's contextvar carrier is not in scope
            fut = self.scheduler.submit(self.decode_name, row,
                                        deadline_ms=rem,
                                        trace=sess.trace)
        except BaseException as e:
            self._finish(sess, error=e)
            return
        fut.add_done_callback(lambda f: self._on_step(sess, f))

    def _on_step(self, sess: DecodeSession, fut) -> None:
        """Future callback (scheduler worker): consume this round-trip's
        result, maybe finish, else chain the next row. Every path ends in
        _finish or _submit_next."""
        with self._lock:
            if sess._finished:
                return
        try:
            y = fut.result()
        except BaseException as e:
            self._finish(sess, error=e)
            return
        try:
            if sess.cancelled:
                self._finish(sess, outcome="cancelled")
                return
            n = int(np.asarray(y)[0, 0])
            if n <= 0:
                self._submit_next(sess)
                return
            toks = np.asarray(y)[0, 1:1 + n].astype(np.int64)
            now = time.monotonic()
            tid = sess.trace.trace_id if sess.trace is not None else None
            if sess.ttft_ms is None:
                sess.ttft_ms = (now - sess.opened_at) * 1000.0
                self._h_ttft.observe(sess.ttft_ms, exemplar=tid)
            else:
                # tokens arrive in a burst of n: the per-token latency is
                # the window gap amortized over the window
                gap_ms = (now - sess._last_tok_at) * 1000.0
                for _ in range(n):
                    self._h_itl.observe(gap_ms / n, exemplar=tid)
            sess._last_tok_at = now
            hit_eos, appended = False, 0
            for t in toks:
                tok = int(t)
                sess.generated.append(tok)
                appended += 1
                sess._events.put({"token": tok,
                                  "index": len(sess.generated) - 1})
                if sess.eos_id is not None and tok == sess.eos_id:
                    hit_eos = True
                    break   # the device stopped emitting after EOS too
            self._c_tokens.inc(appended)
            if hit_eos or len(sess.generated) >= sess.max_tokens:
                self._finish(sess, outcome="completed")
            else:
                self._submit_next(sess)
        except BaseException as e:
            self._finish(sess, error=e)

    def _finish(self, sess: DecodeSession, *, outcome: Optional[str] = None,
                error: Optional[BaseException] = None) -> None:
        with self._lock:
            if sess._finished:
                return
            sess._finished = True
            self._sessions.pop(sess.id, None)
            n_active = len(self._sessions)
        if error is not None:
            outcome = ("expired" if isinstance(error, DeadlineExceededError)
                       else "failed")
        sess.outcome = outcome
        sess.error = error
        if sess.trace is not None:
            reqtrace.record_span(
                sess.trace.trace_id, "session.close",
                parent_id=sess.trace.span_id, session=sess.id,
                slot=sess.slot, outcome=outcome,
                tokens=len(sess.generated),
                error=None if error is None else type(error).__name__)
        # release the session's page references (pages the radix index
        # adopted survive on its own refcount) and its slot in ONE
        # critical section: an admission waiting for a slot counts the
        # free pages as soon as it gets one, so the pages go back first;
        # the draft's mirror row is zeroed before the slot's next tenant
        # can prefill it (target lock, then draft lock)
        with self.pool.lock():
            for p in sess._pages if self.prefix_enabled else ():
                self.pool.page_unref_locked(p)
            sess._pages = []
            if self.draft_pool is not None:
                self.draft_pool.reset(sess.slot)
            self.pool.free_locked(sess.slot)
        self._c_out[outcome].inc()
        self._g_active.set(n_active)
        get_flight().record(
            "session_close", model=self.model, session=sess.id,
            outcome=outcome, tokens=len(sess.generated),
            error=None if error is None else type(error).__name__)
        if error is not None:
            sess._events.put({"error": str(error), "outcome": outcome})
        else:
            sess._events.put({"done": True, "outcome": outcome,
                              "tokens": len(sess.generated)})
        sess.done.set()

    # ------------------------------------------------- scheduler runner
    def run_batch(self, xs) -> np.ndarray:
        """The decode endpoint's data plane. `xs` stacks session rows
        ([k, 3 + chunk], possibly from k sessions). Under the pool lock:
        one `session_step` over the prefill lanes (no host read), then
        one `session_decode_window` advancing every decoding lane K
        tokens. After the lock, ONE device-to-host copy of the window's
        packed tokens and emit flags. Returns one row per request row:
        `[count, tok_0..]` (count 0 for prefill legs).

        Speculating, the draft's pool lock nests inside the target's:
        the prefill is mirrored into the draft, and the window becomes
        the draft's propose plus the target's verify; the one host read
        is the verify's packed rows (counts, catch-up token, tokens)."""
        xs = np.asarray(xs)
        if xs.ndim != 2 or xs.shape[1] != 3 + self.prefill_chunk:
            raise ValueError(
                f"decode rows must be [k, {3 + self.prefill_chunk}], "
                f"got {xs.shape}")
        k = xs.shape[0]
        # the fan-in window the scheduler worker opened when a row of
        # this dispatch is traced; None keeps the untraced path bare
        dtrace = reqtrace.active_dispatch()
        t0 = time.perf_counter() if dtrace is not None else 0.0
        slots_idx = xs[:, 0].astype(np.int64)
        phase = xs[:, 1].astype(np.int64)
        nvalid = xs[:, 2].astype(np.int64)
        pre = np.nonzero(phase == 0)[0]
        dec = np.nonzero(phase == 1)[0]
        S, K = self.pool.slots, self.fused_k
        # a spec window emits up to spec_k accepted drafts plus one
        W = (self.spec_k + 1) if self.spec_enabled else K
        ys = np.zeros((k, 1 + W), np.float32)

        bucket = 0
        emit_n: Dict[int, int] = {}
        acc_n: Dict[int, int] = {}
        if pre.size:
            need = int(nvalid[pre].max())
            bucket = min(b for b in self.buckets if b >= need)
            tok = np.zeros((S, bucket), np.int64)
            val = np.zeros((S, bucket), np.float32)
        act_p = np.zeros((S,), bool)
        for i in pre:
            s, n = int(slots_idx[i]), int(nvalid[i])
            tok[s, :n] = xs[i, 3:3 + n].astype(np.int64)
            val[s, :n] = 1.0
            act_p[s] = True

        # window lanes: sampling knobs / seeds / budgets from the session
        # table (safe: each session has exactly this one row in flight)
        act_d = np.zeros((S,), bool)
        by_slot: Dict[int, DecodeSession] = {}
        if dec.size:
            with self._lock:
                by_slot = {s.slot: s for s in self._sessions.values()}
            tok0 = np.zeros((S,), np.int64)
            lane_params: List[Optional[SamplingParams]] = [None] * S
            keys = np.zeros((S, 2), np.uint32)
            offs = np.zeros((S,), np.int32)
            buds = np.zeros((S,), np.int32)
            eos = np.full((S,), -1, np.int32)
            rew = np.zeros((S,), np.int32)
            ptk = np.zeros((S,), np.int32)
            pvl = np.zeros((S,), bool)
            for i in dec:
                s = int(slots_idx[i])
                sess = by_slot.get(s)
                if sess is None:
                    continue    # finished while the row was queued
                act_d[s] = True
                tok0[s] = int(xs[i, 3])
                lane_params[s] = sess.params
                keys[s] = sess.base_key
                offs[s] = len(sess.generated)
                buds[s] = sess.max_tokens - len(sess.generated)
                if sess.eos_id is not None:
                    eos[s] = sess.eos_id
                rew[s] = sess._spec_rewind
                ptk[s] = sess._spec_pre_tok
                pvl[s] = sess._spec_pre_valid
            temps, tks, tps, grd = lane_param_arrays(lane_params,
                                                     self.vocab)
            knobs = dict(temperature=temps, top_k=tks, top_p=tps,
                         greedy=grd, keys=keys, offsets=offs)

        packed_d = spec_d = None
        with self.pool.lock():
            # drop rows whose slot was freed while the row was queued
            for i in range(k):
                s = int(slots_idx[i])
                if not self.pool._active[s]:
                    act_p[s] = False
                    act_d[s] = False
            net = self.pool.net
            carries = self.pool.carries
            if pre.size and act_p.any():
                x = _encode(tok, self._encoding, self.vocab)
                _, carries = net.session_step(
                    x, carries, active=act_p, valid=val)
            if self.spec_enabled:
                # target pool, then draft pool: every acquirer nests them
                # in this order
                with self.draft_pool.lock():
                    dnet = self.draft_pool.net
                    dcarries = self.draft_pool.carries
                    if pre.size and act_p.any():
                        _, dcarries = dnet.session_step(
                            x, dcarries, active=act_p, valid=val)
                    if dec.size and act_d.any():
                        d_toks, d_probs, dcarries = \
                            dnet.session_propose_window(
                                tok0, dcarries, active=act_d,
                                k=self.spec_k, rewind=rew, pre_tokens=ptk,
                                pre_valid=pvl, **knobs)
                        spec_d, carries = net.session_verify_window(
                            tok0, carries, active=act_d, k=self.spec_k,
                            draft_tokens=d_toks, draft_probs=d_probs,
                            budgets=buds, eos_ids=eos, **knobs)
                    self.draft_pool.swap_carries(dcarries)
            elif dec.size and act_d.any():
                toks_d, emits_d, carries = net.session_decode_window(
                    tok0, carries, active=act_d, k=K, budgets=buds,
                    eos_ids=eos, **knobs)
                packed_d = torch.stack((toks_d, emits_d.to(toks_d.dtype)))
            self.pool.swap_carries(carries)
        if spec_d is not None:
            # the one host read of the window, after both locks
            ph = spec_d.cpu().numpy()
            wtoks = wdraft = wacc = 0
            for i in dec:
                s = int(slots_idx[i])
                if not act_d[s]:
                    continue
                n = int(ph[s, 0])
                # the accepted drafts actually emitted: a budget or EOS
                # cut truncates an accepted run
                acc = min(int(ph[s, 1]), n)
                emit_n[s], acc_n[s] = n, acc
                ys[i, 0] = n
                ys[i, 1:1 + n] = ph[s, 3:3 + n]
                sess = by_slot.get(s)
                if sess is not None:
                    # the next window's draft entry (this was the
                    # session's one row in flight)
                    sess._spec_rewind = max(self.spec_k - n, 0)
                    sess._spec_pre_valid = n == self.spec_k + 1
                    sess._spec_pre_tok = int(ph[s, 2])
                wtoks += n
                wdraft += self.spec_k
                wacc += acc
                self._h_accept.observe(acc / self.spec_k)
            self._c_windows.inc()
            self._c_window_tokens.inc(wtoks)
            self._c_draft_toks.inc(wdraft)
            self._c_accepted.inc(wacc)
        if packed_d is not None:
            # the one host read of the window, after releasing the lock
            packed = packed_d.cpu().numpy()
            toks_h, emits_h = packed[0], packed[1].astype(bool)
            wtoks = 0
            for i in dec:
                s = int(slots_idx[i])
                if not act_d[s]:
                    continue
                n = int(emits_h[s].sum())
                emit_n[s] = n
                ys[i, 0] = n
                ys[i, 1:1 + K] = toks_h[s]
                wtoks += n
            self._c_windows.inc()
            self._c_window_tokens.inc(wtoks)
        self._c_disp.inc()
        self._c_rows.inc(k)
        if k >= 2:
            self._c_shared.inc()
        if dtrace is not None:
            self._trace_windows(dtrace, slots_idx, phase, nvalid, emit_n,
                                acc_n, bucket, k,
                                (time.perf_counter() - t0) * 1e3)
        return ys

    def _trace_windows(self, dtrace, slots_idx, phase, nvalid,
                       emit_n: dict, acc_n: dict, bucket: int, k: int,
                       dur_ms: float) -> None:
        """One `session.window` span per traced row of this dispatch,
        parented on that trace's dispatch span: the phase, the window
        (`win`: K or spec_k for a decode row, the chunk for a prefill
        row), the tokens it emitted, and the decode kernel the target's
        attention runs (host scalars only)."""
        with self._lock:
            by_slot = {s.slot: s for s in self._sessions.values()
                       if s.trace is not None}
            kernels = ",".join(sorted({r["kernel"] for r in
                                       self._kernel_policy_rows
                                       if r["net"] == "target"})) or "n/a"
        for i in range(slots_idx.shape[0]):
            s = int(slots_idx[i])
            sess = by_slot.get(s)
            if sess is None:
                continue
            sid = dtrace.span_ids.get(sess.trace.trace_id)
            if sid is None:
                continue        # co-batched with a different endpoint
            decode = int(phase[i]) == 1
            reqtrace.record_span(
                sess.trace.trace_id, "session.window", parent_id=sid,
                dur_ms=dur_ms, session=sess.id, slot=sess.slot,
                phase="decode" if decode else "prefill",
                step=len(sess.generated),
                win=int((self.spec_k if self.spec_enabled
                         else self.fused_k) if decode else nvalid[i]),
                tokens=int(emit_n.get(s, 0)), bucket=bucket, rows=k,
                spec=bool(self.spec_enabled and decode),
                accepted=int(acc_n.get(s, 0)),
                prefix_cache=int(sess._cached_len),
                kernel=kernels, loop=self.loop_kind)

    # --------------------------------------------------------- hot-swap
    def _deploy_hook(self, phase: str, name: str, version, net) -> None:
        if phase == "warm":
            # the canary: live sessions must fit on the candidate (else
            # the deploy rolls back, sessions untouched), and its session
            # calls run once now, so the flip costs no capture
            self._check_swap_compat(net)
            self._warm(net)
            return
        if phase == "flipped":
            self.pool.rebind(net)
            if self.prefix_enabled:
                # old-weight KV must not serve NEW sessions: bump the
                # generation first (in-flight old sessions then never
                # re-index), then drop every cached chain; live sessions
                # finish on the pages they hold
                with self.pool.lock():
                    self._prefix_gen += 1
                    self.prefix_cache.flush()
            rows = self._kernel_policy(net)
            with self._lock:
                self._kernel_policy_rows = rows
                n = len(self._sessions)
            self.entry.net = net
            self.entry.version = version
            get_flight().record("decode_sessions_migrated", model=name,
                                version=version, live_sessions=n)
            logger.info("decode sessions migrated to %s@%r (%d live)",
                        name, version, n)

    def _check_swap_compat(self, net) -> None:
        """Raise IncompatibleSessionSwapError unless the live sessions can
        move onto `net`: the same vocabulary, rewindable caches when
        speculating, pageable ones under the prefix cache, and a carry
        tree of the live pool's layout."""
        _, vocab = _resolve_net(net)
        if int(vocab) != self.vocab:
            raise IncompatibleSessionSwapError(
                f"deploy candidate for {self.model!r} has vocabulary "
                f"{vocab}, the live sessions {self.vocab}; rolling back")
        if self.spec_enabled and not net.spec_decode_capable():
            raise IncompatibleSessionSwapError(
                f"deploy candidate for {self.model!r} cannot rewind its "
                f"decode caches (recurrent carries or rolling rings) — "
                f"this manager speculates; rolling back")
        if self.prefix_enabled and not net.prefix_cache_capable():
            raise IncompatibleSessionSwapError(
                f"deploy candidate for {self.model!r} cannot page its "
                f"KV caches — this manager runs the prefix cache; "
                f"rolling back")
        with self.pool.lock():
            have = carry_layout(self.pool.carries)
        if self.pool.candidate_layout(net) != have:
            raise IncompatibleSessionSwapError(
                f"deploy candidate for {self.model!r} cannot host the live "
                f"session carries; rolling back")

    # -------------------------------------------------------- lifecycle
    def snapshot(self) -> dict:
        with self._lock:
            active = len(self._sessions)
            policy = list(self._kernel_policy_rows)
        drafted = int(self._c_draft_toks.value)
        accepted = int(self._c_accepted.value)
        snap = {
            "model": self.model,
            "endpoint": self.decode_name,
            "sessions": {
                "active": active,
                "opened": int(self._c_opened.value),
                **{o: int(self._c_out[o].value) for o in _OUTCOMES},
            },
            "slots": self.pool.describe(),
            "tokens_streamed": int(self._c_tokens.value),
            "ttft_ms": self._h_ttft.percentiles(),
            "itl_ms": self._h_itl.percentiles(),
            "dispatches": {"total": int(self._c_disp.value),
                           "rows": int(self._c_rows.value),
                           "shared": int(self._c_shared.value),
                           "windows": int(self._c_windows.value),
                           "window_tokens":
                               int(self._c_window_tokens.value)},
            "buckets": list(self.buckets),
            "kernel_policy": policy,
            "decode_loop": {"kind": self.loop_kind, "k": self.fused_k,
                            "reason": self._loop_reason},
            "spec_decode": {
                "enabled": self.spec_enabled, "k": self.spec_k,
                "reason": self._spec_reason, "draft": self.draft_name,
                "draft_tokens": drafted, "accepted_tokens": accepted,
                "acceptance_rate": (round(accepted / drafted, 4)
                                    if drafted else None)},
            "kv_dtype": {"kind": self.kv_dtype,
                         "reason": self._kv_reason},
            "prefix_cache": {"enabled": self.prefix_enabled,
                             "page_len": (self.page_len
                                          if self.prefix_enabled else 0),
                             "reason": self._prefix_reason},
        }
        if self.prefix_cache is not None:
            with self.pool.lock():
                snap["prefix_cache"].update(self.prefix_cache.stats())
                snap["prefix_cache"]["pages"] = self.pool.pages
                snap["prefix_cache"]["pages_free"] = \
                    self.pool.pages_free_locked()
        return snap

    def _kernel_policy(self, net) -> list:
        """Which decode kernel each attention shape of `net` (and of the
        draft, whose rows say `"net": "draft"`) runs single-token steps
        on: B6 over a paged pool, B5 over the slot pool. Recorded at
        construction and at a hot-swap flip; a shape the CUDA kernels
        cannot take fails here."""
        out = []
        for who, n, paged in (("target", net, self.prefix_enabled),
                              ("draft", self.draft_net, False)):
            if who == "draft" and not self.spec_enabled:
                continue
            seen = set()
            for layer in getattr(n, "layers", ()):
                heads = getattr(layer, "num_heads", None)
                if heads is None or not hasattr(layer, "decode_carry"):
                    continue
                hkv = getattr(layer, "num_kv_heads", None) or heads
                key = (layer.max_cache, heads, hkv)
                if key in seen:
                    continue
                seen.add(key)
                width = getattr(layer, "n_out", None) or layer.n_in
                pol = decode_attention_policy(
                    heads, hkv, width // heads, paged=paged,
                    device=n.device)
                out.append({"net": who, "layer": layer.name,
                            "cache_len": key[0], "heads": heads,
                            "kv_heads": hkv, "kernel": pol.kernel,
                            "reason": pol.reason})
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for every live session to finish."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                live = list(self._sessions.values())
            if not live:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            live[0].done.wait(0.05)

    def shutdown(self) -> None:
        """Abort every live session (clients get a terminal error event).
        Called by registry.close() through the entry's runner seam, or
        directly."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            live = list(self._sessions.values())
        for sess in live:
            self._finish(sess, error=SchedulerClosedError(
                "decode session manager shut down"))
        self.registry.remove_deploy_hook(self.model, self._deploy_hook)
