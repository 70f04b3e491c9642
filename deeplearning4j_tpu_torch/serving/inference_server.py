"""Model-serving control plane: the REST front over the ModelRegistry and
the continuous-batching scheduler (port of
`deeplearning4j_tpu/serving/inference_server.py`).

  POST /output   {"ndarray": [[...], ...], "model": "name"?,
                  "deadline_ms": 250?}
                 -> {"output": [[...], ...], "model": ..., "version": ...}
                 errors: 400 client fault, 503 shed/draining,
                 504 deadline exceeded, 500 server fault
  POST /generate {"prompt_ids": [...], "model"?, "max_tokens"?,
                  "temperature"/"top_k"/"top_p"/"greedy"?, "seed"?,
                  "deadline_ms"?, "eos_id"?, "stream"? (default true)}
                 -> SSE token stream (a first frame naming the session,
                 one `data:` frame per token, then a terminal done/error
                 frame), or one JSON body with "stream": false. Needs
                 decode sessions (`decode_slots=N` or
                 `enable_decode_sessions()`); slot exhaustion -> 503; a
                 client disconnect cancels the session.
  POST /generate/cancel {"session": id, "model"?} -> {"cancelled": bool}
  GET  /sessions -> per-model decode snapshot
  GET  /models   -> per-model {version, served, inflight, deployments}
  GET  /metrics  -> the ServingStats snapshot (plus the decode snapshots)
                 as JSON by default; Prometheus text exposition
                 (`text/plain; version=0.0.4`) for `Accept: text/plain`
                 or openmetrics, or `?format=prometheus`; the raw
                 registry snapshot for `?format=registry`
  GET  /healthz  -> {"status": "ok" | "degraded", "reasons": [...]}:
                 degraded when the admission queue passes
                 `degraded_fraction` of capacity, the recompile watchdog
                 tripped on one of this server's runners, a slot worker
                 is crash-looping, or an SLO is firing (one reason each)
  GET  /series   -> the sampled telemetry series (needs `slo=True` or
                 `enable_slo()`; `?window=60&prefix=serving_` filters):
                 one point per registry series a sampler tick, histograms
                 as `:count` / `:p50` / `:p95` / `:p99`
  GET  /slo      -> the SLO engine's last evaluation: burn rates over the
                 fast and slow windows, firing state, breach counts and
                 their trace ids, anomaly-watch warnings; `?refresh=1`
                 ticks first
  GET  /devices  -> one DeviceMonitor sample: each card's allocator bytes
                 in use and peak, its memory, active blocks
  GET  /flight   -> the FlightRecorder ring (recent spans, captures,
                 session and deploy events, device samples) and the
                 paths of the dumps written; `GET /flight/latest` the
                 newest dump; `POST /flight/dump {"reason"?}` writes one
  GET  /trace/{id} -> the span tree of one traced request (the HTTP root,
                 queue.wait, the shared dispatch, session.window leaves);
                 `GET /trace` (or `/trace/`) lists the stored ids.
                 Sampling: `DL4J_TPU_TRACE_SAMPLE` at the edge; shed,
                 expired and crashed requests always trace. A traced
                 request's JSON body, every SSE frame of its stream and
                 its error body carry its `trace_id` (an untraced one's
                 error body the forced trace's id)

Dispatch modes: `batched=True, scheduler="continuous"` (default, the
ContinuousBatchingScheduler), `batched=True, scheduler="collect"` (the
`ParallelInference` BATCHED collector) and `batched=False` (a direct
call from each HTTP thread).

`stop()` takes JAX's steps with one more bound: it stops accepting
requests, aborts the live decode sessions (each SSE client gets the
manager's terminal frame), then joins the request threads, then shuts
the scheduler and the registry down. A handler still waiting
`stop_grace_s` after the sessions were aborted (a session or batch that
never finishes) gives up with a terminal error frame or a 503, so no
request thread can hold the join.
The series sampler thread (`slo=True`) stops before the request
threads are joined.
"""

from __future__ import annotations

import queue
import time
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.observe import reqtrace
from deeplearning4j_tpu_torch.observe.registry import PROMETHEUS_CONTENT_TYPE
from deeplearning4j_tpu_torch.parallel.inference import InferenceMode
from deeplearning4j_tpu_torch.serving.http_base import (
    HttpError, JsonHttpServer, StreamResponse, TextResponse,
)
from deeplearning4j_tpu_torch.serving.kv_pool import SlotPoolExhaustedError
from deeplearning4j_tpu_torch.serving.metrics import ServingStats
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.scheduler import (
    AdmissionPolicy, ContinuousBatchingScheduler, DeadlineExceededError,
    RequestShedError, SchedulerClosedError,
)

DEFAULT_MODEL = "default"

# how often a waiting handler looks whether stop() has begun
_POLL_S = 0.1


class InferenceServer(JsonHttpServer):
    """One HTTP server, many models. `net` is a convenience: deployed as
    ("default", version 1) without warm-up; `deploy()` warms by
    default."""

    # seconds a handler keeps waiting once stop() has aborted the decode
    # sessions (see the module docstring)
    stop_grace_s = 5.0

    def __init__(self, net=None, *, port: int = 0, batched: bool = True,
                 max_batch_size: int = 64,
                 registry: Optional[ModelRegistry] = None,
                 scheduler: str = "continuous",
                 admission: str = AdmissionPolicy.BLOCK,
                 queue_capacity: int = 256,
                 default_deadline_ms: Optional[float] = None,
                 batch_buckets=None, collect_wait_ms: float = 5.0,
                 slots: int = 1, degraded_fraction: float = 0.8,
                 mesh=None, metrics=None, decode_slots: int = 0,
                 decode_prefill_chunk: int = 8,
                 decode_fused_k: Optional[int] = None,
                 decode_draft_net=None,
                 decode_spec_k: Optional[int] = None,
                 decode_kv_dtype: Optional[str] = None,
                 decode_page_len: Optional[int] = None,
                 slo: bool = False,
                 slo_objectives=None,
                 series_interval: Optional[float] = None):
        super().__init__(port=port)
        if scheduler not in ("continuous", "collect"):
            raise ValueError("scheduler must be 'continuous' or 'collect'")
        if mesh is not None:
            raise NotImplementedError(
                "serving over a device mesh is not ported yet (ROADMAP.md "
                "A6); the port serves on one card")
        self.mode = ("continuous" if batched and scheduler == "continuous"
                     else "collect" if batched else "direct")
        # `metrics`: a shared MetricsRegistry (observe.get_registry()) so
        # /metrics publishes the whole process's telemetry; default is a
        # private registry per server
        self.stats = ServingStats(registry=metrics)
        self.degraded_fraction = degraded_fraction
        if registry is None:
            registry = ModelRegistry(
                max_batch_size=max_batch_size, batch_buckets=batch_buckets,
                runner_mode=(InferenceMode.BATCHED
                             if self.mode == "collect"
                             else InferenceMode.INPLACE),
                collect_wait_ms=collect_wait_ms)
        self.registry = registry
        self.scheduler = None
        if self.mode == "continuous":
            self.scheduler = ContinuousBatchingScheduler(
                registry, self.stats, max_batch_size=max_batch_size,
                queue_capacity=queue_capacity, policy=admission,
                default_deadline_ms=default_deadline_ms, slots=slots)
        self._decode = {}
        self._stopped_at = None
        self._series_store = None
        self._sampler = None
        self._slo = None
        self._anomaly = None
        if slo:
            self.enable_slo(slos=slo_objectives, interval=series_interval)
        if net is not None:
            self.registry.deploy(DEFAULT_MODEL, 1, net, warm=False)
            if decode_slots:
                self.enable_decode_sessions(
                    slots=decode_slots,
                    prefill_chunk=decode_prefill_chunk,
                    fused_k=decode_fused_k,
                    draft_net=decode_draft_net,
                    spec_k=decode_spec_k,
                    kv_dtype=decode_kv_dtype,
                    page_len=decode_page_len)

    # ------------------------------------------------------ control API
    def deploy(self, name: str, version, net, *, feat_shape=None,
               warm: bool = True):
        """Hot-swap: warm the new version, flip traffic atomically (live
        decode sessions move onto it), drain and retire the old one."""
        return self.registry.deploy(name, version, net,
                                    feat_shape=feat_shape, warm=warm)

    def enable_decode_sessions(self, model: str = DEFAULT_MODEL, *,
                               slots: int = 4, prefill_chunk: int = 8,
                               fused_k: Optional[int] = None,
                               draft_net=None,
                               spec_k: Optional[int] = None,
                               kv_dtype: Optional[str] = None,
                               page_len: Optional[int] = None,
                               warm: bool = True):
        """Attach a DecodeSessionManager to `model`: POST /generate
        streams tokens from per-request sessions over a shared KV slot
        pool. `fused_k` is the decode window length, `draft_net` a
        speculative draft (same vocabulary, rewindable caches) with
        `spec_k` proposals a window, `kv_dtype` ("int8"/"fp8") the
        pools' cache storage, `page_len` the prefix cache's page; each
        defers to its `ops/kernel_defaults` policy."""
        if self.mode != "continuous":
            raise ValueError(
                "decode sessions need the continuous scheduler "
                f"(server mode is {self.mode!r})")
        if model in self._decode:
            raise ValueError(f"decode sessions already enabled "
                             f"for {model!r}")
        from deeplearning4j_tpu_torch.serving.sessions import (
            DecodeSessionManager,
        )
        mgr = DecodeSessionManager(
            self.registry, self.scheduler, model, slots=slots,
            prefill_chunk=prefill_chunk, fused_k=fused_k,
            draft_net=draft_net, spec_k=spec_k, kv_dtype=kv_dtype,
            page_len=page_len, metrics=self.stats.registry, warm=warm)
        self._decode[model] = mgr
        return mgr

    def enable_slo(self, *, slos=None, interval: Optional[float] = None,
                   anomaly: bool = True):
        """Turn on the telemetry series sampler and the SLO engine: a
        background thread samples `self.stats.registry` every `interval`
        (default DL4J_TPU_SERIES_INTERVAL) seconds into a bounded
        SeriesStore, and the SLOEngine (objectives `slos`, default
        `default_slos()`) and AnomalyWatch evaluate on each tick, off the
        request path. Surfaces: GET /series, GET /slo, and /healthz."""
        if self._sampler is not None:
            return self._slo
        from deeplearning4j_tpu_torch.observe.series import (
            SeriesSampler, SeriesStore,
        )
        from deeplearning4j_tpu_torch.observe.slo import (
            AnomalyWatch, SLOEngine,
        )
        self._series_store = SeriesStore()
        self._sampler = SeriesSampler(self._series_store,
                                      registry=self.stats.registry,
                                      interval=interval)
        # queue gauges move only when /metrics renders; push them every
        # tick so the series (and the SLOs over them) stay live
        self._sampler.add_callback(self._push_queue_gauges)
        self._slo = SLOEngine(self._series_store,
                              registry=self.stats.registry, slos=slos)
        self._sampler.add_callback(self._slo.evaluate)
        if anomaly:
            self._anomaly = AnomalyWatch(self._series_store,
                                         registry=self.stats.registry)
            self._sampler.add_callback(self._anomaly.check)
        self._sampler.start()
        return self._slo

    def _push_queue_gauges(self, now=None):
        depth = self.scheduler.queue_depth() if self.scheduler else None
        cap = self.scheduler.capacity if self.scheduler else None
        self.stats.set_queue_gauges(depth, cap)

    # --------------------------------------------------------- handlers
    def _parse(self, req: dict):
        x_raw = req["ndarray"]          # KeyError -> 400
        try:
            x = np.asarray(x_raw, np.float32)
        except (TypeError, ValueError) as e:
            raise HttpError(400, f"bad ndarray payload: {e}")
        if x.ndim < 2:
            raise HttpError(400, "ndarray must be [batch, features...]")
        model = req.get("model", DEFAULT_MODEL)
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
            except (TypeError, ValueError):
                raise HttpError(400, "deadline_ms must be a number")
        return x, model, deadline_ms

    @staticmethod
    def _trace_extra(rt) -> dict:
        return {"trace_id": rt.trace_id} if rt is not None else {}

    def _output(self, req: dict):
        x, model, deadline_ms = self._parse(req)
        # the trace is born at the HTTP edge; None on the sampled-off
        # path, where every seam below pays one `is None` check
        rt = reqtrace.new_trace("http.output")
        try:
            y, version = self._output_dispatch(model, x, deadline_ms, rt)
        except HttpError as e:
            reqtrace.finish_root(rt, route="/output", model=model,
                                 status=e.status)
            if rt is not None:
                e.payload.setdefault("trace_id", rt.trace_id)
            raise
        out = {"output": np.asarray(y).tolist(), "model": model,
               "version": version}
        if rt is not None:
            reqtrace.finish_root(rt, route="/output", model=model,
                                 status=200, rows=int(x.shape[0]))
            out["trace_id"] = rt.trace_id
        return out

    def _output_dispatch(self, model, x, deadline_ms, rt):
        if self.mode == "continuous":
            try:
                fut = self.scheduler.submit(model, x, deadline_ms,
                                            trace=rt)
                while True:
                    try:
                        y = fut.result(timeout=_POLL_S)
                        break
                    except TimeoutError:
                        if self._given_up():
                            raise HttpError(
                                503, "draining: the server stopped "
                                "before this batch ran")
                return y, getattr(fut, "version", None)
            except RequestShedError as e:
                raise HttpError(503, f"shed: {e}",
                                **reqtrace.error_extra(e))
            except DeadlineExceededError as e:
                raise HttpError(504, f"deadline exceeded: {e}",
                                **reqtrace.error_extra(e))
            except SchedulerClosedError as e:
                raise HttpError(503, f"draining: {e}")
            except KeyError:
                raise HttpError(400, f"unknown model: {model!r}")
        t0 = time.monotonic()
        try:
            entry = self.registry.acquire(model)
        except KeyError:
            raise HttpError(400, f"unknown model: {model!r}")
        self.stats.admitted(model)
        try:
            y = entry.output(x)
            version = entry.version
        except BaseException:
            self.stats.completed(model, 0.0, ok=False)
            raise
        finally:
            self.registry.release(entry)
        self.stats.completed(model, time.monotonic() - t0)
        return y, version

    def _generate(self, req: dict):
        """Open a session and stream its tokens: SSE by default (a client
        disconnect cancels the session), or one JSON body with
        "stream": false."""
        model = req.get("model", DEFAULT_MODEL)
        mgr = self._decode.get(model)
        if mgr is None:
            raise HttpError(
                400, f"decode sessions are not enabled for {model!r}")
        prompt = req["prompt_ids"]              # KeyError -> 400
        kw = {}
        for field, cast in (("max_tokens", int), ("temperature", float),
                            ("top_k", int), ("top_p", float),
                            ("greedy", bool), ("seed", int),
                            ("deadline_ms", float), ("eos_id", int)):
            if req.get(field) is not None:
                try:
                    kw[field] = cast(req[field])
                except (TypeError, ValueError):
                    raise HttpError(400, f"bad {field}: {req[field]!r}")
        rt = reqtrace.new_trace("http.generate")
        try:
            sess = mgr.open_session(prompt, trace=rt, **kw)
        except SlotPoolExhaustedError as e:
            reqtrace.finish_root(rt, route="/generate", status=503)
            raise HttpError(503, f"no free decode slot: {e}",
                            **self._trace_extra(rt))
        except SchedulerClosedError as e:
            reqtrace.finish_root(rt, route="/generate", status=503)
            raise HttpError(503, f"draining: {e}", **self._trace_extra(rt))
        except (TypeError, ValueError) as e:
            reqtrace.finish_root(rt, route="/generate", status=400)
            raise HttpError(400, str(e), **self._trace_extra(rt))
        if req.get("stream", True):
            def frames():
                yield {"session": sess.id, "model": model}
                while True:
                    try:
                        yield from sess.stream(timeout=_POLL_S)
                        return
                    except queue.Empty:
                        if self._given_up():
                            yield {"error": "server stopped",
                                   "outcome": "cancelled"}
                            return

            def events():
                try:
                    for ev in frames():
                        # a traced stream names its trace in every
                        # frame; an untraced one's error frame names
                        # the forced trace of its error, if any
                        tid = (rt.trace_id if rt is not None else
                               getattr(sess.error, "trace_id", None)
                               if "error" in ev else None)
                        yield dict(ev, trace_id=tid) if tid else ev
                finally:
                    # a client disconnect lands here as GeneratorExit
                    if not sess.done.is_set():
                        sess.cancel()
                    reqtrace.finish_root(
                        rt, route="/generate", model=model,
                        session=sess.id, tokens=len(sess.generated),
                        outcome=sess.outcome)
            return StreamResponse(events())
        while not sess.done.wait(_POLL_S):
            if self._given_up():
                sess.cancel()
                reqtrace.finish_root(rt, route="/generate", model=model,
                                     session=sess.id, status=503)
                raise HttpError(503, "the server stopped before the "
                                "session finished",
                                **self._trace_extra(rt))
        try:
            tokens = sess.result()
        except DeadlineExceededError as e:
            reqtrace.finish_root(rt, route="/generate", model=model,
                                 session=sess.id, status=504)
            raise HttpError(504, f"deadline exceeded: {e}",
                            **(reqtrace.error_extra(e)
                               or self._trace_extra(rt)))
        except (RequestShedError, SchedulerClosedError) as e:
            reqtrace.finish_root(rt, route="/generate", model=model,
                                 session=sess.id, status=503)
            raise HttpError(503, str(e),
                            **(reqtrace.error_extra(e)
                               or self._trace_extra(rt)))
        out = {"session": sess.id, "model": model, "tokens": tokens,
               "outcome": sess.outcome, "ttft_ms": sess.ttft_ms}
        if rt is not None:
            reqtrace.finish_root(rt, route="/generate", model=model,
                                 session=sess.id, status=200,
                                 tokens=len(tokens),
                                 outcome=sess.outcome)
            out["trace_id"] = rt.trace_id
        return out

    def _generate_cancel(self, req: dict):
        model = req.get("model", DEFAULT_MODEL)
        mgr = self._decode.get(model)
        if mgr is None:
            raise HttpError(
                400, f"decode sessions are not enabled for {model!r}")
        sid = req["session"]                    # KeyError -> 400
        return {"session": sid, "cancelled": mgr.cancel(sid)}

    def _sessions(self):
        return {"decode": {m: mgr.snapshot()
                           for m, mgr in self._decode.items()}}

    def _owned_watchdog_tags(self):
        """Watchdog tags of THIS server's runners (`ParallelInference`
        owner tags of the registry's entries): /healthz folds trips of
        these only, so another component's churn in the same process
        cannot degrade this server."""
        tags = set()
        for name in self.registry.names():
            try:
                entry = self.registry.get(name)
            except KeyError:
                continue
            tag = getattr(entry.runner, "owner_tag", None)
            if tag:
                tags.add(tag)
        return tags

    def _healthz(self):
        """Degraded, with a reason each, when the admission queue passes
        `degraded_fraction` of capacity, the recompile watchdog tripped
        on one of this server's runners, a slot worker is crash-looping,
        or an SLO is firing."""
        depth = self.scheduler.queue_depth() if self.scheduler else 0
        cap = self.scheduler.capacity if self.scheduler else None
        reasons = []
        if cap is not None and depth >= self.degraded_fraction * cap:
            reasons.append(f"admission queue saturated ({depth}/{cap})")
        from deeplearning4j_tpu_torch.observe.watchdog import get_watchdog

        owned = self._owned_watchdog_tags()
        snap = get_watchdog().snapshot()["per_owner"] if owned else {}
        tripped = sorted(t for t, o in snap.items()
                         if o["warned"] and t in owned)
        if tripped:
            reasons.append(
                "recompile watchdog tripped: " + ", ".join(tripped))
        streak = (self.scheduler.restart_streak()
                  if self.scheduler else 0)
        if streak:
            reasons.append(
                f"slot worker crash-looping (streak {streak})")
        firing = self._slo.firing() if self._slo is not None else []
        for name in firing:
            reasons.append(f"slo firing: {name}")
        out = {"status": "degraded" if reasons else "ok",
               "reasons": reasons, "mode": self.mode,
               "queue_depth": depth, "queue_capacity": cap,
               "models": self.registry.names()}
        if self._slo is not None:
            out["slo_firing"] = firing
            if firing:
                out["slo_breaches"] = self._slo.breaches()
        return out

    def _series(self, request=None):
        """GET /series — the sampled series. Query: `window` (seconds of
        history) and `prefix` (key filter)."""
        if self._series_store is None:
            return {"enabled": False, "series": {}}
        q = (request or {}).get("query", {})

        def _f(name):
            try:
                return float(q[name][0]) if q.get(name) else None
            except (TypeError, ValueError):
                raise HttpError(400, f"bad {name!r} query param")
        out = self._series_store.snapshot(
            window_s=_f("window"),
            prefix=(q.get("prefix") or [None])[0])
        out["enabled"] = True
        out["interval_s"] = self._sampler.interval
        out["ticks"] = self._sampler.ticks
        return out

    def _slo_route(self, request=None):
        """GET /slo — the engine's last evaluation (`?refresh=1` ticks
        first)."""
        if self._slo is None:
            return {"enabled": False, "slos": [], "firing": []}
        q = (request or {}).get("query", {})
        if q.get("refresh"):
            self._sampler.sample_once()
        out = dict(self._slo.snapshot())
        out["enabled"] = True
        if self._anomaly is not None:
            out["anomalies"] = list(self._anomaly.warnings)
        return out

    def _metrics(self, request=None):
        depth = self.scheduler.queue_depth() if self.scheduler else 0
        cap = self.scheduler.capacity if self.scheduler else None
        fmt = (request or {}).get("query", {}).get("format", [])
        if fmt and fmt[0].lower() == "registry":
            self.stats.set_queue_gauges(depth, cap)
            return self.stats.registry.snapshot()
        if request is not None and self._wants_prometheus(request):
            self.stats.set_queue_gauges(depth, cap)
            return TextResponse(self.stats.registry.to_prometheus(),
                                content_type=PROMETHEUS_CONTENT_TYPE)
        snap = self.stats.snapshot(queue_depth=depth, queue_capacity=cap)
        if self._decode:        # additive: only when sessions exist
            snap["decode"] = {m: mgr.snapshot()
                              for m, mgr in self._decode.items()}
        return snap

    @staticmethod
    def _wants_prometheus(request) -> bool:
        """Scrapers advertise text/plain (or openmetrics) in Accept; JSON
        consumers send no preference."""
        fmt = request.get("query", {}).get("format", [])
        if fmt:
            return fmt[0].lower() in ("prometheus", "text")
        accept = (request.get("headers") or {}).get("Accept", "") or ""
        return "text/plain" in accept or "openmetrics" in accept

    def _devices(self):
        from deeplearning4j_tpu_torch.observe.devicemon import (
            get_device_monitor,
        )

        mon = get_device_monitor()
        return {"devices": mon.sample_once(), "polls": mon.polls,
                "monitor_running": mon.running}

    def _flight(self):
        from deeplearning4j_tpu_torch.observe.flight import get_flight

        return get_flight().snapshot()

    def _flight_sub(self, suffix: str, request=None):
        """GET /flight/latest — the newest dump on disk as JSON (404 when
        none exists). Events are capped so the response stays bounded."""
        from deeplearning4j_tpu_torch.observe.flight import (
            get_flight, latest_dump, read_dump,
        )

        sub = suffix.strip("/")
        if sub != "latest":
            raise HttpError(404, f"unknown flight endpoint: {sub!r}")
        path = latest_dump(get_flight().dump_dir)
        if path is None:
            raise HttpError(404, "no flight dump recorded yet")
        doc = read_dump(path)
        events = doc.get("events")
        if isinstance(events, list) and len(events) > 500:
            doc["events"] = events[-500:]
            doc["events_truncated"] = len(events) - 500
        doc["path"] = path
        return doc

    def _flight_dump(self, req: dict):
        """POST /flight/dump — write a dump now."""
        from deeplearning4j_tpu_torch.observe.flight import get_flight

        reason = str(req.get("reason") or "requested")[:120]
        path = get_flight().dump(reason)
        return {"ok": path is not None, "path": path, "reason": reason}

    def _trace_list(self):
        store = reqtrace.get_trace_store()
        ids = store.ids()
        return {"traces": ids[-50:], "count": len(ids),
                "sample_rate": reqtrace.sample_rate()}

    def _trace(self, suffix: str, request=None):
        tid = suffix.strip("/")
        if not tid:
            return self._trace_list()
        tree = reqtrace.get_trace_store().tree(tid)
        if tree is None:
            raise HttpError(404, f"unknown trace: {tid!r}")
        return tree

    def get_routes(self):
        return {"/healthz": self._healthz, "/metrics": self._metrics,
                "/models": lambda: {"models": self.registry.summary()},
                "/devices": self._devices, "/flight": self._flight,
                "/sessions": self._sessions, "/trace": self._trace_list,
                "/series": self._series, "/slo": self._slo_route}

    def get_prefix_routes(self):
        return {"/trace/": self._trace, "/flight/": self._flight_sub}

    def post_routes(self):
        return {"/output": self._output, "/generate": self._generate,
                "/generate/cancel": self._generate_cancel,
                "/flight/dump": self._flight_dump}

    def _given_up(self) -> bool:
        """True once a waiting handler should stop waiting: stop() aborted
        the decode sessions `stop_grace_s` ago."""
        t = self._stopped_at
        return t is not None and time.monotonic() - t >= self.stop_grace_s

    def stop(self):
        self.stop_listening()
        # the sampler thread reads the stats and the scheduler: stop it
        # before the request threads are joined and those torn down
        if self._sampler is not None:
            self._sampler.stop()
        # abort live decode sessions before the request threads are
        # joined: their SSE handlers end on the terminal frame, and their
        # callback chains stop resubmitting into the scheduler, so the
        # scheduler and registry shutdowns below drain
        for mgr in self._decode.values():
            mgr.shutdown()
        self._stopped_at = time.monotonic()
        super().stop()
        if self.scheduler is not None:
            self.scheduler.shutdown()
        self.registry.close()


# the control-plane name; same object
ModelServer = InferenceServer
