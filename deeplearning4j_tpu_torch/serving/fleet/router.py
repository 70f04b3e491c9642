"""FleetRouter — the HTTP front door over N replicas (port of
`deeplearning4j_tpu/serving/fleet/router.py`).

One request's life, disaggregated: the router picks a DECODE home by
sticky session id, prefix-overlap hints, and load; if a PREFILL-role
replica exists and the decode home looks cold for this prompt, the
stem is prefilled there, the warm pages ship over the dtype-aware
handoff path (quantized bytes + scale rows, never dequantized), and
the decode replica's next admission matches the whole stem — its
`/generate` goes straight to the fused decode window. The router then
proxies the SSE stream, re-numbering tokens so a mid-stream replica
death is invisible to the client: the stream resumes on another
replica (warm KV if a handoff/export survives, re-prefill otherwise)
and greedy output is bit-identical to an uninterrupted run.

Control loop: a poller hits every replica's `/healthz`; a replica
whose burn-rate SLO fires — or that stops answering — is
DRAINED: no new placements, live sessions' warm stems are exported
through `/fleet/kv/export` and installed into healthy replicas, and
the sticky map repoints. Coordinated hot-swap fans a declarative spec
out to every replica and rolls every already-flipped replica back if
any replica's deploy watchdog trips.

Concurrency contract: the replica table, session→replica map, token
history, prefix hints, and in-flight handoff set are all guarded by
`_lock`; NO network call ever happens under `_lock` — every route
snapshots state under the lock, talks HTTP unlocked, then re-takes the
lock to write back.

Traces: each request is ONE causal tree rooted at the router
(`fleet.generate` → `route` / `prefill.hop` / `handoff` /
`decode.hop` / `failover` spans), with the replicas' own trace ids
attached to the hop spans — cross-process correlation without a
cross-process collector.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observe import MetricsRegistry, reqtrace
from deeplearning4j_tpu_torch.observe.registry import PROMETHEUS_CONTENT_TYPE
from deeplearning4j_tpu_torch.serving.http_base import (
    HttpError, JsonHttpServer, StreamResponse, TextResponse,
)
from deeplearning4j_tpu_torch.serving.fleet import client
from deeplearning4j_tpu_torch.serving.fleet.handoff import payload_bytes

logger = logging.getLogger("deeplearning4j_tpu")

DEFAULT_MODEL = "default"


class NoReplicaAvailableError(RuntimeError):
    """Every candidate replica is down, draining, or excluded."""


class ReplicaHandle:
    """Router-side record of one replica. Mutable fields are owned by
    the router and guarded by the router lock; the object itself never
    does I/O."""

    __slots__ = ("name", "url", "role", "draining", "healthy",
                 "fail_streak", "inflight", "slo_drained", "last_info")

    def __init__(self, name: str, url: str, role: str = "mixed"):
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"bad replica role {role!r}")
        self.name = name
        self.url = url
        self.role = role
        self.draining = False
        self.healthy = True
        self.fail_streak = 0
        self.inflight = 0
        self.slo_drained = False
        self.last_info: Optional[dict] = None

    def describe(self) -> dict:
        return {"name": self.name, "url": self.url, "role": self.role,
                "draining": self.draining, "healthy": self.healthy,
                "fail_streak": self.fail_streak,
                "inflight": self.inflight,
                "slo_drained": self.slo_drained}


class FleetRouter(JsonHttpServer):
    """HTTP front door: placement, disaggregated prefill→decode
    handoff, mid-stream failover, drain migration, SLO-driven control,
    and fleet-coordinated hot-swap."""

    MAX_FAILOVERS = 2           # per stream, on top of the first home
    HINTS_PER_REPLICA = 256     # recent stems kept for overlap scoring
    SESSION_HISTORY = 4096      # fleet sessions kept for migration

    def __init__(self, replicas=(), *, port: int = 0,
                 poll_interval: Optional[float] = 1.0,
                 auto_drain_on_slo: bool = True,
                 disaggregate: bool = True,
                 handoff_min_tokens: int = 2,
                 unhealthy_after: int = 2,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(port=port)
        self._lock = threading.Lock()
        # guarded by _lock
        self._replicas: Dict[str, ReplicaHandle] = {}
        # fleet session id -> replica name (sticky placement)
        # guarded by _lock
        self._sessions: Dict[str, str] = {}
        # fleet session id -> full token history (prompt + generated),
        # the export key for drain migration; bounded FIFO
        # guarded by _lock
        self._history: "dict[str, list]" = {}
        # guarded by _lock
        self._history_order: "deque[str]" = deque()
        # replica name -> recent prompt stems (router-side overlap
        # hints against that replica's radix index)
        # guarded by _lock
        self._hints: Dict[str, deque] = {}
        # in-flight handoff keys ("sid->replica"), for /fleet visibility
        # guarded by _lock
        self._handoffs = set()
        # model name -> {"version", "spec", "targets"} of the last
        # successful fleet-wide deploy: the rollback source
        # guarded by _lock
        self._specs: Dict[str, dict] = {}
        self._sid_counter = itertools.count(1)
        self.poll_interval = poll_interval
        self.auto_drain_on_slo = auto_drain_on_slo
        self.disaggregate = disaggregate
        self.handoff_min_tokens = int(handoff_min_tokens)
        self.unhealthy_after = int(unhealthy_after)
        self.registry = metrics if metrics is not None \
            else MetricsRegistry()
        m = self.registry
        self._c_requests = m.counter("fleet_requests_total")
        self._c_tokens = m.counter("fleet_tokens_streamed_total")
        self._c_reroutes = m.counter("fleet_reroutes_total")
        self._c_handoffs = m.counter("fleet_handoffs_total")
        self._c_handoff_fail = m.counter("fleet_handoff_failures_total")
        self._c_handoff_bytes = m.counter("fleet_handoff_bytes_total")
        self._c_migrations = m.counter("fleet_migrations_total")
        self._c_slo_drains = m.counter("fleet_slo_drains_total")
        self._c_deploys = m.counter("fleet_deploys_total")
        self._c_rollbacks = m.counter("fleet_deploy_rollbacks_total")
        self._c_failed = m.counter("fleet_failed_requests_total")
        self._g_replicas = m.gauge("fleet_replicas")
        self._g_healthy = m.gauge("fleet_replicas_healthy")
        self._g_draining = m.gauge("fleet_replicas_draining")
        self._g_inflight = m.gauge("fleet_inflight")
        self._h_ttft = m.histogram("fleet_ttft_ms")
        self._h_req = m.histogram("fleet_request_ms")
        for spec in replicas:
            if isinstance(spec, ReplicaHandle):
                self.add_replica(spec)
            elif isinstance(spec, dict):
                self.add_replica(ReplicaHandle(**spec))
            else:
                self.add_replica(ReplicaHandle(*spec))
        self._poller: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the fleet observability plane: federation scrapes, trace
        # stitching, incident bundles — all pull-based, driven from
        # the poll loop (never from a stream's dispatch path)
        from deeplearning4j_tpu_torch.serving.fleet.obsplane import (
            FleetObsPlane,
        )
        self.obsplane = FleetObsPlane(self)

    # ------------------------------------------------------------ topo
    def add_replica(self, handle: ReplicaHandle) -> None:
        with self._lock:
            self._replicas[handle.name] = handle
            self._hints.setdefault(
                handle.name, deque(maxlen=self.HINTS_PER_REPLICA))
            self._refresh_gauges_locked()

    def replica_urls(self) -> Dict[str, str]:
        """name -> url for every known replica (healthy or not): the
        obsplane's view of the fleet, copied under the lock so scrapes
        and stitches run with NO router lock held."""
        with self._lock:
            return {name: r.url for name, r in self._replicas.items()}

    def _refresh_gauges_locked(self) -> None:
        # every caller holds self._lock (the
        # *_locked naming contract, same as the pool's page API)
        reps = list(self._replicas.values())
        self._g_replicas.set(len(reps))
        self._g_healthy.set(sum(r.healthy for r in reps))
        self._g_draining.set(sum(r.draining for r in reps))
        self._g_inflight.set(sum(r.inflight for r in reps))

    # ------------------------------------------------------- lifecycle
    def start(self) -> int:
        port = super().start()
        if self.poll_interval:
            # lifecycle — start() runs before any
            # handler thread exists, nothing to race with yet
            self._stop.clear()
            # lifecycle — single-threaded start()
            self._poller = threading.Thread(
                target=self._poll_loop, name="fleet-poller", daemon=True)
            self._poller.start()
        return port

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5.0)
            # lifecycle — poller already joined,
            # handlers are torn down by super().stop() next
            self._poller = None
        super().stop()

    # ------------------------------------------------------- placement
    @staticmethod
    def _lcp(a, b) -> int:
        n = min(len(a), len(b))
        for i in range(n):
            if a[i] != b[i]:
                return i
        return n

    def _overlap_locked(self, name: str, stem) -> int:
        # caller holds self._lock by contract
        hints = self._hints.get(name)
        if not hints:
            return 0
        return max((self._lcp(stem, h) for h in hints), default=0)

    def _place(self, stem, fleet_sid: Optional[str],
               exclude=(), *, roles=("decode", "mixed")) -> ReplicaHandle:
        """Pick a home: sticky session first, then prefix-overlap minus
        a load penalty, least-loaded tiebreak. Raises
        NoReplicaAvailableError when the candidate set is empty."""
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.healthy and not r.draining
                     and r.role in roles and r.name not in exclude]
            if not cands:
                raise NoReplicaAvailableError(
                    f"no healthy replica for roles {roles} "
                    f"(excluded: {sorted(exclude)})")
            if fleet_sid is not None:
                home = self._sessions.get(fleet_sid)
                for r in cands:
                    if r.name == home:
                        return r
            # overlap in tokens is worth more than a queued stream:
            # one cached page saves a whole prefill chunk of work
            best, best_score = None, None
            for r in cands:
                score = self._overlap_locked(r.name, stem) \
                    - 4 * r.inflight
                if best_score is None or score > best_score:
                    best, best_score = r, score
            return best

    def _note_stream_start_locked(self, r: ReplicaHandle,
                                  fleet_sid: str) -> None:
        # caller holds self._lock by contract
        r.inflight += 1
        # caller holds self._lock by contract
        self._sessions[fleet_sid] = r.name
        self._refresh_gauges_locked()

    def _note_stream_end(self, name: str, fleet_sid: str,
                         stem, history) -> None:
        with self._lock:
            r = self._replicas.get(name)
            if r is not None and r.inflight > 0:
                r.inflight -= 1
            if stem:
                hints = self._hints.get(name)
                if hints is not None:
                    hints.append(tuple(stem))
            if fleet_sid not in self._history:
                self._history_order.append(fleet_sid)
                while len(self._history_order) > self.SESSION_HISTORY:
                    old = self._history_order.popleft()
                    self._history.pop(old, None)
                    self._sessions.pop(old, None)
            self._history[fleet_sid] = list(history)
            self._refresh_gauges_locked()

    def _mark_failure(self, name: str) -> None:
        """A network-level failure talking to `name`: bump the streak,
        and past the threshold stop placing anything there (the poller
        marks it healthy again when /healthz answers)."""
        crashed = False
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                return
            r.fail_streak += 1
            if r.fail_streak >= self.unhealthy_after:
                crashed = r.healthy      # the healthy->dead transition
                r.healthy = False
            self._refresh_gauges_locked()
        if crashed:
            # collect evidence while the survivors still remember the
            # dead replica's streams (outside the lock: the collector
            # does network I/O)
            self.obsplane.trigger_incident(
                f"replica_crash_{name}", sorted(self.replica_urls()),
                {"replica": name})

    # ------------------------------------------------- disaggregation
    def _maybe_disaggregate(self, model: str, prompt: List[int],
                            target: ReplicaHandle, fleet_sid: str,
                            rt) -> None:
        """Prefill the stem on a prefill-role replica and hand the
        pages to `target`. Best-effort: any failure leaves the decode
        replica to prefill for itself (correctness never depends on a
        handoff landing)."""
        stem = prompt[:-1]
        if not self.disaggregate or \
                len(stem) < self.handoff_min_tokens:
            return
        with self._lock:
            prefillers = [r for r in self._replicas.values()
                          if r.healthy and not r.draining
                          and r.role == "prefill"
                          and r.name != target.name]
            if not prefillers:
                return
            if self._overlap_locked(target.name, stem) >= len(stem):
                return          # target already warm for this stem
            pf = min(prefillers, key=lambda r: r.inflight)
            key = f"{fleet_sid}->{target.name}"
            self._handoffs.add(key)
        t0 = time.monotonic()
        ok = False
        try:
            pre = client.post_json(
                pf.url, "/fleet/prefill",
                {"model": model, "prompt_ids": prompt}, timeout=60.0)
            if rt is not None:
                reqtrace.record_span(
                    rt.trace_id, "prefill.hop", parent_id=rt.span_id,
                    replica=pf.name, model=model,
                    replica_trace=pre.get("trace_id"),
                    prefill_ms=pre.get("prefill_ms"),
                    dur_ms=(time.monotonic() - t0) * 1000.0)
            payload = pre.get("payload")
            if payload is None:
                return
            t1 = time.monotonic()
            imp = client.post_json(
                target.url, "/fleet/kv/import",
                {"model": model, "payload": payload}, timeout=60.0)
            nbytes = payload_bytes(payload)
            self._c_handoffs.inc()
            self._c_handoff_bytes.inc(nbytes)
            ok = True
            if rt is not None:
                reqtrace.record_span(
                    rt.trace_id, "handoff", parent_id=rt.span_id,
                    src=pf.name, dst=target.name,
                    cached_len=imp.get("cached_len"),
                    pages=len(payload.get("pages", ())),
                    bytes=nbytes,
                    dur_ms=(time.monotonic() - t1) * 1000.0)
        except (client.ReplicaUnreachable, client.ReplicaHTTPError) as e:
            logger.warning("fleet handoff %s failed: %s",
                           f"{pf.name}->{target.name}", e)
            if isinstance(e, client.ReplicaUnreachable):
                self._mark_failure(pf.name)
        finally:
            if not ok:
                self._c_handoff_fail.inc()
            with self._lock:
                self._handoffs.discard(key)

    # ------------------------------------------------------- generate
    def _generate(self, req: dict):
        model = req.get("model", DEFAULT_MODEL)
        prompt = [int(t) for t in req["prompt_ids"]]   # KeyError → 400
        if not prompt:
            raise HttpError(400, "prompt_ids must be non-empty")
        fleet_sid = str(req.get("fleet_session")
                        or f"f{next(self._sid_counter):08d}")
        max_tokens = int(req.get("max_tokens", 16))
        rt = reqtrace.new_trace("fleet.generate")
        self._c_requests.inc()
        stem = tuple(prompt[:-1])
        try:
            target = self._place(stem, fleet_sid)
        except NoReplicaAvailableError as e:
            self._c_failed.inc()
            reqtrace.finish_root(rt, route="/generate", status=503)
            raise HttpError(503, str(e))
        if rt is not None:
            reqtrace.record_span(rt.trace_id, "route",
                                 parent_id=rt.span_id,
                                 replica=target.name, model=model,
                                 fleet_session=fleet_sid)
        self._maybe_disaggregate(model, prompt, target, fleet_sid, rt)
        with self._lock:
            self._note_stream_start_locked(target, fleet_sid)
        body = {k: req[k] for k in
                ("temperature", "top_k", "top_p", "greedy", "seed",
                 "deadline_ms", "eos_id") if req.get(k) is not None}
        body.update({"model": model, "prompt_ids": prompt,
                     "max_tokens": max_tokens, "stream": True})
        if req.get("stream", True):
            return StreamResponse(self._proxy_stream(
                model, prompt, body, target, fleet_sid, rt))
        # non-stream: drain our own proxy generator so failover applies
        tokens, outcome, error = [], None, None
        for ev in self._proxy_stream(model, prompt, body, target,
                                     fleet_sid, rt):
            if "token" in ev:
                tokens.append(ev["token"])
            elif "error" in ev:
                error, outcome = ev["error"], ev.get("outcome")
            elif "done" in ev:
                outcome = ev.get("outcome")
        if error is not None:
            raise HttpError(500, f"fleet generate failed: {error}")
        return {"fleet_session": fleet_sid, "model": model,
                "tokens": tokens, "outcome": outcome,
                **({"trace_id": rt.trace_id} if rt is not None else {})}

    def _proxy_stream(self, model: str, prompt: List[int], body: dict,
                      target: ReplicaHandle, fleet_sid: str, rt):
        """Yield client-facing SSE events, failing over to another
        replica when the current one dies mid-stream. Token indices are
        re-numbered router-side so the resumed stream is seamless; the
        resume prompt is `prompt + tokens_so_far`, which for greedy
        sampling continues the identical sequence (the chaos suite
        pins byte-equality against an uninterrupted run)."""
        t0 = time.monotonic()
        emitted: List[int] = []
        max_tokens = int(body["max_tokens"])
        current = target
        failovers = 0
        ttft_seen = False
        first = {"fleet_session": fleet_sid, "replica": current.name,
                 "model": model}
        if rt is not None:
            first["trace_id"] = rt.trace_id
        yield first
        try:
            while True:
                attempt_body = dict(body)
                if emitted:
                    # resume after a failover: everything streamed so
                    # far becomes prompt, budget shrinks accordingly
                    attempt_body["prompt_ids"] = prompt + emitted
                    attempt_body["max_tokens"] = \
                        max_tokens - len(emitted)
                    attempt_body["_migration"] = True
                hop_t0 = time.monotonic()
                hop_sess = None
                try:
                    for ev in client.sse_events(current.url, "/generate",
                                                attempt_body,
                                                timeout=120.0):
                        if "token" in ev:
                            if not ttft_seen:
                                ttft_seen = True
                                self._h_ttft.observe(
                                    (time.monotonic() - t0) * 1000.0)
                            emitted.append(int(ev["token"]))
                            self._c_tokens.inc()
                            yield {"token": ev["token"],
                                   "index": len(emitted) - 1,
                                   "replica": current.name}
                        elif "session" in ev:
                            hop_sess = ev.get("session")
                            if rt is not None:
                                reqtrace.record_span(
                                    rt.trace_id, "decode.hop",
                                    parent_id=rt.span_id,
                                    replica=current.name,
                                    session=hop_sess,
                                    replica_trace=ev.get("trace_id"),
                                    resumed=bool(failovers))
                        elif "done" in ev or "error" in ev:
                            # a replica-REPORTED terminal (deadline,
                            # cancel, …): the replica is alive, this
                            # is the stream's real verdict — forward
                            out = dict(ev)
                            out["fleet_session"] = fleet_sid
                            out["tokens"] = len(emitted)
                            if "error" in ev:
                                self._c_failed.inc()
                            yield out
                            return
                except client.ReplicaUnreachable as e:
                    self._mark_failure(current.name)
                    self._c_reroutes.inc()
                    failovers += 1
                    if rt is not None:
                        reqtrace.record_span(
                            rt.trace_id, "failover",
                            parent_id=rt.span_id, dead=current.name,
                            session=hop_sess, error=str(e)[:200],
                            tokens_so_far=len(emitted),
                            dur_ms=(time.monotonic() - hop_t0)
                            * 1000.0)
                    # detached collector: never slows this stream's
                    # own failover
                    self.obsplane.trigger_incident(
                        f"failover_{current.name}",
                        sorted(self.replica_urls()),
                        {"dead": current.name,
                         "fleet_session": fleet_sid,
                         "tokens_so_far": len(emitted),
                         **({"trace_id": rt.trace_id}
                            if rt is not None else {})})
                    if failovers > self.MAX_FAILOVERS:
                        self._c_failed.inc()
                        yield {"error": f"stream failed after "
                               f"{failovers} replicas: {e}",
                               "fleet_session": fleet_sid,
                               "tokens": len(emitted)}
                        return
                    if len(emitted) >= max_tokens:
                        # the budget was already met when the replica
                        # died on the terminal frame — finish cleanly
                        yield {"done": True, "outcome": "completed",
                               "fleet_session": fleet_sid,
                               "tokens": len(emitted)}
                        return
                    try:
                        nxt = self._place(
                            tuple(prompt[:-1]), None,
                            exclude={current.name})
                    except NoReplicaAvailableError as e2:
                        self._c_failed.inc()
                        yield {"error": str(e2),
                               "fleet_session": fleet_sid,
                               "tokens": len(emitted)}
                        return
                    with self._lock:
                        self._note_stream_start_locked(nxt, fleet_sid)
                        cur = self._replicas.get(current.name)
                        if cur is not None and cur.inflight > 0:
                            cur.inflight -= 1
                    current = nxt
                except client.ReplicaHTTPError as e:
                    # alive but refusing (503 draining / slots full):
                    # place elsewhere without marking it dead
                    self._c_reroutes.inc()
                    failovers += 1
                    if failovers > self.MAX_FAILOVERS:
                        self._c_failed.inc()
                        yield {"error": str(e),
                               "fleet_session": fleet_sid,
                               "tokens": len(emitted)}
                        return
                    try:
                        nxt = self._place(tuple(prompt[:-1]), None,
                                          exclude={current.name})
                    except NoReplicaAvailableError as e2:
                        self._c_failed.inc()
                        yield {"error": str(e2),
                               "fleet_session": fleet_sid,
                               "tokens": len(emitted)}
                        return
                    with self._lock:
                        self._note_stream_start_locked(nxt, fleet_sid)
                        cur = self._replicas.get(current.name)
                        if cur is not None and cur.inflight > 0:
                            cur.inflight -= 1
                    current = nxt
        finally:
            self._h_req.observe((time.monotonic() - t0) * 1000.0)
            self._note_stream_end(current.name, fleet_sid,
                                  prompt[:-1], prompt + emitted)
            if rt is not None:
                reqtrace.finish_root(
                    rt, route="/generate", model=model,
                    fleet_session=fleet_sid, tokens=len(emitted),
                    failovers=failovers, replica=current.name)

    # -------------------------------------------------- drain/migrate
    def drain_replica(self, name: str, *, migrate: bool = True,
                      reason: str = "manual") -> dict:
        """Mark `name` draining, stop placing new sessions there, and
        migrate its sticky sessions' warm KV stems into healthy
        replicas through export → install. Live streams keep running
        on the draining replica until they finish (drain ≠ kill)."""
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                raise HttpError(404, f"unknown replica {name!r}")
            r.draining = True
            self._refresh_gauges_locked()
            moved_sids = [sid for sid, home in self._sessions.items()
                          if home == name]
            history = {sid: list(self._history.get(sid, ()))
                       for sid in moved_sids}
        rt = reqtrace.new_trace("fleet.drain")
        try:
            client.post_json(r.url, "/fleet/drain", {"draining": True},
                             timeout=10.0)
        # best-effort notify — the drain proceeds
        # router-side regardless; an unreachable replica is already
        # effectively drained of new traffic
        except (client.ReplicaUnreachable, client.ReplicaHTTPError):
            pass
        migrated, failed = 0, 0
        for sid in moved_sids:
            toks = history.get(sid) or []
            try:
                dst = self._place(tuple(toks), None, exclude={name})
            except NoReplicaAvailableError:
                failed += len(moved_sids) - migrated - failed
                break
            ok = False
            if migrate and toks:
                try:
                    exp = client.post_json(
                        r.url, "/fleet/kv/export",
                        {"tokens": toks}, timeout=60.0)
                    payload = exp.get("payload")
                    if payload is not None:
                        client.post_json(
                            dst.url, "/fleet/kv/import",
                            {"payload": payload}, timeout=60.0)
                        ok = True
                        self._c_handoff_bytes.inc(
                            payload_bytes(payload))
                except (client.ReplicaUnreachable,
                        client.ReplicaHTTPError) as e:
                    logger.warning("drain migration of %s failed: %s",
                                   sid, e)
            with self._lock:
                self._sessions[sid] = dst.name
                hints = self._hints.get(dst.name)
                if hints is not None and toks:
                    hints.append(tuple(toks))
            migrated += 1
            self._c_migrations.inc()
            if rt is not None:
                reqtrace.record_span(
                    rt.trace_id, "migrate", parent_id=rt.span_id,
                    session=sid, src=name, dst=dst.name,
                    kv_handed_off=ok, tokens=len(toks))
        if rt is not None:
            reqtrace.finish_root(rt, replica=name, reason=reason,
                                 migrated=migrated, failed=failed)
        return {"replica": name, "draining": True, "reason": reason,
                "migrated": migrated, "failed": failed}

    def undrain_replica(self, name: str) -> dict:
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                raise HttpError(404, f"unknown replica {name!r}")
            r.draining = False
            r.slo_drained = False
            self._refresh_gauges_locked()
        try:
            client.post_json(r.url, "/fleet/drain", {"draining": False},
                             timeout=10.0)
        # best-effort notify — router-side routing
        # state is authoritative; the poller reconciles replica state
        except (client.ReplicaUnreachable, client.ReplicaHTTPError):
            pass
        return {"replica": name, "draining": False}

    # ------------------------------------------------------- SLO loop
    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            # the control loop must survive any single poll's failure —
            # the next tick retries, and the log keeps the evidence
            # control loop logs and retries
            except Exception:
                logger.exception("fleet poll failed")

    def poll_once(self) -> dict:
        """One control tick: refresh every replica's health from its
        /healthz, and drain any replica whose burn-rate SLO is firing
        (traffic reroutes; its sessions migrate out warm)."""
        with self._lock:
            snapshot = list(self._replicas.values())
        verdicts = {}
        to_drain = []
        for r in snapshot:
            try:
                hz = client.get_json(r.url, "/healthz", timeout=5.0)
            except (client.ReplicaUnreachable,
                    client.ReplicaHTTPError) as e:
                verdicts[r.name] = f"unreachable: {e}"
                self._mark_failure(r.name)
                continue
            slo_firing = [s for s in hz.get("reasons", ())
                          if s.startswith("slo firing")]
            verdicts[r.name] = (hz.get("status", "?")
                                + (f" ({'; '.join(slo_firing)})"
                                   if slo_firing else ""))
            with self._lock:
                r.fail_streak = 0
                r.healthy = True
                if r.slo_drained and not slo_firing:
                    # breach cleared: lift the automatic drain
                    r.draining = False
                    r.slo_drained = False
                want_drain = (self.auto_drain_on_slo and slo_firing
                              and not r.draining)
                if want_drain:
                    r.slo_drained = True
                self._refresh_gauges_locked()
            if want_drain:
                to_drain.append((r.name, "; ".join(slo_firing)))
        for name, reason in to_drain:
            self._c_slo_drains.inc()
            logger.warning("fleet: draining %s (%s)", name, reason)
            self.obsplane.trigger_incident(
                f"slo_drain_{name}", sorted(self.replica_urls()),
                {"replica": name, "reason": reason})
            try:
                self.drain_replica(name, reason=f"slo: {reason}")
            # replica vanished between verdict and
            # drain — the next poll round marks it unhealthy anyway
            except HttpError:
                pass
        # federation tick rides the same poll: scrape every replica's
        # registry, merge, and evaluate the fleet-scope SLOs
        try:
            self.obsplane.scrape_once()
        # federation is advisory — a failed scrape
        # must not take down the health poll; the next tick retries
        except Exception:
            logger.exception("fleet scrape failed")
        return verdicts

    # -------------------------------------------- coordinated deploy
    def _fleet_deploy(self, req: dict):
        """Deploy `targets` (e.g. `<model>` and `<model>@draft`) across
        EVERY replica as one transaction: any replica's deploy-watchdog
        trip rolls back every already-flipped (replica, target) pair to
        the previous fleet spec."""
        targets = req.get("targets")
        if targets is None:
            if not isinstance(req.get("spec"), dict):
                raise HttpError(400,
                                "deploy needs targets=[...] or "
                                "{name, version, spec}")
            targets = [{"name": req.get("name", DEFAULT_MODEL),
                        "version": req.get("version"),
                        "spec": req["spec"]}]
        for t in targets:
            if t.get("version") is None or \
                    not isinstance(t.get("spec"), dict):
                raise HttpError(400, f"bad deploy target: {t}")
        with self._lock:
            replicas = [r for r in self._replicas.values() if r.healthy]
            prev = {t["name"]: self._specs.get(t["name"])
                    for t in targets}
        rt = reqtrace.new_trace("fleet.deploy")
        done = []               # (replica, target) pairs flipped
        failure = None
        for r in replicas:
            for t in targets:
                t0 = time.monotonic()
                try:
                    res = client.post_json(
                        r.url, "/fleet/deploy",
                        {"name": t["name"], "version": t["version"],
                         "spec": t["spec"]}, timeout=120.0)
                except (client.ReplicaUnreachable,
                        client.ReplicaHTTPError) as e:
                    res = {"ok": False, "error": str(e)}
                if rt is not None:
                    reqtrace.record_span(
                        rt.trace_id, "deploy.hop",
                        parent_id=rt.span_id, replica=r.name,
                        target=t["name"], ok=res.get("ok", False),
                        rolled_back=res.get("rolled_back", False),
                        dur_ms=(time.monotonic() - t0) * 1000.0)
                if not res.get("ok"):
                    failure = {"replica": r.name, "target": t["name"],
                               "error": res.get("error", "deploy "
                                                "failed")}
                    break
                done.append((r, t))
            if failure:
                break
        if failure is None:
            with self._lock:
                for t in targets:
                    self._specs[t["name"]] = {
                        "version": t["version"], "spec": t["spec"]}
                # new weights mean every replica's radix flushed: the
                # router's overlap hints are stale, drop them
                for hints in self._hints.values():
                    hints.clear()
            self._c_deploys.inc()
            if rt is not None:
                reqtrace.finish_root(rt, ok=True,
                                     replicas=len(replicas),
                                     targets=len(targets))
            return {"ok": True, "replicas": [r.name for r in replicas],
                    "targets": [t["name"] for t in targets],
                    **({"trace_id": rt.trace_id}
                       if rt is not None else {})}
        # rollback everywhere that already flipped
        rolled, rollback_errors = [], []
        for r, t in done:
            pv = prev.get(t["name"])
            if pv is None:
                rollback_errors.append(
                    {"replica": r.name, "target": t["name"],
                     "error": "no previous fleet spec recorded"})
                continue
            try:
                res = client.post_json(
                    r.url, "/fleet/deploy",
                    {"name": t["name"], "version": pv["version"],
                     "spec": pv["spec"]}, timeout=120.0)
                if res.get("ok"):
                    rolled.append({"replica": r.name,
                                   "target": t["name"]})
                else:
                    rollback_errors.append(
                        {"replica": r.name, "target": t["name"],
                         "error": res.get("error", "rollback failed")})
            except (client.ReplicaUnreachable,
                    client.ReplicaHTTPError) as e:
                rollback_errors.append(
                    {"replica": r.name, "target": t["name"],
                     "error": str(e)})
        self._c_rollbacks.inc()
        self.obsplane.trigger_incident(
            "deploy_rollback", sorted(self.replica_urls()),
            {"failure": failure, "rolled_back": len(rolled),
             "rollback_errors": len(rollback_errors)})
        if rt is not None:
            reqtrace.finish_root(rt, ok=False,
                                 failed_replica=failure["replica"],
                                 rolled_back=len(rolled))
        return {"ok": False, "failure": failure, "rolled_back": rolled,
                "rollback_errors": rollback_errors,
                **({"trace_id": rt.trace_id}
                   if rt is not None else {})}

    # ---------------------------------------------------------- routes
    def _fleet(self, request=None):
        q = (request or {}).get("query", {})
        refresh = bool(q.get("refresh"))
        with self._lock:
            out = {"replicas": [r.describe()
                                for r in self._replicas.values()],
                   "sessions": len(self._sessions),
                   "handoffs_inflight": sorted(self._handoffs),
                   "specs": {k: v["version"]
                             for k, v in self._specs.items()}}
        if refresh:
            infos = {}
            for rep in out["replicas"]:
                try:
                    infos[rep["name"]] = client.get_json(
                        rep["url"], "/fleet/info", timeout=5.0)
                except (client.ReplicaUnreachable,
                        client.ReplicaHTTPError) as e:
                    infos[rep["name"]] = {"error": str(e)}
            out["info"] = infos
        return out

    def _healthz(self):
        with self._lock:
            reps = list(self._replicas.values())
            healthy = sum(1 for r in reps
                          if r.healthy and not r.draining)
        reasons = []
        if not healthy:
            reasons.append("no healthy replica")
        return {"status": "degraded" if reasons else "ok",
                "reasons": reasons, "tier": "router",
                "replicas": len(reps), "routable": healthy}

    def _metrics(self, request=None):
        from deeplearning4j_tpu_torch.serving.inference_server import (
            InferenceServer,
        )
        if request is not None and \
                InferenceServer._wants_prometheus(request):
            return TextResponse(self.registry.to_prometheus(),
                                content_type=PROMETHEUS_CONTENT_TYPE)
        snap = self.registry.snapshot()
        with self._lock:
            snap["fleet"] = {
                "replicas": [r.describe()
                             for r in self._replicas.values()],
                "sessions": len(self._sessions)}
        return snap

    def _drain_route(self, req: dict):
        name = req.get("replica")
        if not name:
            raise HttpError(400, "need {replica: name}")
        if req.get("draining", True):
            return self.drain_replica(
                name, migrate=bool(req.get("migrate", True)))
        return self.undrain_replica(name)

    def _fleet_metrics(self, request=None):
        """GET /fleet/metrics — the federated view: every replica's
        scraped registry merged (restart-safe counter deltas,
        bucket-wise histograms, replica-labeled gauges), scrape
        staleness per replica, and the fleet SLO verdicts."""
        q = (request or {}).get("query", {})
        if q.get("refresh"):
            self.obsplane.scrape_once()
        return self.obsplane.metrics_payload()

    def _fleet_series(self, request=None):
        """GET /fleet/series — the fleet SeriesStore the SLO engine
        burns over (same query params as a replica's /series)."""
        q = (request or {}).get("query", {})

        def _f(name):
            try:
                return float(q[name][0]) if q.get(name) else None
            except (TypeError, ValueError):
                raise HttpError(400, f"bad {name!r} query param")
        out = self.obsplane.store.snapshot(
            window_s=_f("window"),
            prefix=(q.get("prefix") or [None])[0])
        out["scrapes"] = self.obsplane.scrapes
        return out

    def _trace_list(self):
        store = reqtrace.get_trace_store()
        ids = store.ids()
        return {"traces": ids[-50:], "count": len(ids),
                "sample_rate": reqtrace.sample_rate()}

    def _trace(self, suffix: str, request=None):
        """GET /trace/{id} — the router's tree with every hop's replica
        subtree grafted in (one cross-process waterfall). `?raw=1`
        returns the unstitched router-local tree."""
        tid = suffix.strip("/")
        if not tid:
            return self._trace_list()
        q = (request or {}).get("query", {})
        doc = self.obsplane.stitched_trace(tid, raw=bool(q.get("raw")))
        if doc is None:
            raise HttpError(404, f"unknown trace: {tid!r}")
        return doc

    def get_routes(self):
        return {"/fleet": self._fleet, "/healthz": self._healthz,
                "/metrics": self._metrics,
                "/fleet/metrics": self._fleet_metrics,
                "/fleet/series": self._fleet_series,
                "/trace": self._trace_list}

    def get_prefix_routes(self):
        return {"/trace/": self._trace}

    def post_routes(self):
        return {"/generate": self._generate,
                "/fleet/drain": self._drain_route,
                "/fleet/deploy": self._fleet_deploy}
