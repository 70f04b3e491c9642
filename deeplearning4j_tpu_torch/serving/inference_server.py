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
                 `degraded_fraction` of capacity or a slot worker is
                 crash-looping

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

Not ported yet (ROADMAP A8, the observe modules): `/devices`, `/flight`,
`/flight/...`, `/trace`, `/trace/...`, `/series` and `/slo` answer HTTP
501 naming A8; `slo=True`, `slo_objectives=` and `series_interval=`
raise NotImplementedError naming A8; the recompile watchdog's reason is
missing from `/healthz`, and SSE frames and error bodies carry no
`trace_id`.
"""

from __future__ import annotations

import queue
import time
from typing import Optional

import numpy as np

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

_A8 = ("not ported yet: this route needs the observe modules of "
       "ROADMAP.md A8")

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
        for given, what in ((slo, "slo=True"),
                            (slo_objectives is not None, "slo_objectives="),
                            (series_interval is not None,
                             "series_interval=")):
            if given:
                raise NotImplementedError(
                    f"{what} (the series sampler and SLO engine) is not "
                    "ported yet (ROADMAP.md A8)")
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

    def _output(self, req: dict):
        x, model, deadline_ms = self._parse(req)
        y, version = self._output_dispatch(model, x, deadline_ms)
        return {"output": np.asarray(y).tolist(), "model": model,
                "version": version}

    def _output_dispatch(self, model, x, deadline_ms):
        if self.mode == "continuous":
            try:
                fut = self.scheduler.submit(model, x, deadline_ms)
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
                raise HttpError(503, f"shed: {e}")
            except DeadlineExceededError as e:
                raise HttpError(504, f"deadline exceeded: {e}")
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
        try:
            sess = mgr.open_session(prompt, **kw)
        except SlotPoolExhaustedError as e:
            raise HttpError(503, f"no free decode slot: {e}")
        except SchedulerClosedError as e:
            raise HttpError(503, f"draining: {e}")
        except (TypeError, ValueError) as e:
            raise HttpError(400, str(e))
        if req.get("stream", True):
            def events():
                try:
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
                finally:
                    # a client disconnect lands here as GeneratorExit
                    if not sess.done.is_set():
                        sess.cancel()
            return StreamResponse(events())
        while not sess.done.wait(_POLL_S):
            if self._given_up():
                sess.cancel()
                raise HttpError(503, "the server stopped before the "
                                "session finished")
        try:
            tokens = sess.result()
        except DeadlineExceededError as e:
            raise HttpError(504, f"deadline exceeded: {e}")
        except (RequestShedError, SchedulerClosedError) as e:
            raise HttpError(503, str(e))
        return {"session": sess.id, "model": model, "tokens": tokens,
                "outcome": sess.outcome, "ttft_ms": sess.ttft_ms}

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

    def _healthz(self):
        """Degraded when the admission queue passes `degraded_fraction`
        of capacity or a slot worker is crash-looping."""
        depth = self.scheduler.queue_depth() if self.scheduler else 0
        cap = self.scheduler.capacity if self.scheduler else None
        reasons = []
        if cap is not None and depth >= self.degraded_fraction * cap:
            reasons.append(f"admission queue saturated ({depth}/{cap})")
        streak = (self.scheduler.restart_streak()
                  if self.scheduler else 0)
        if streak:
            reasons.append(
                f"slot worker crash-looping (streak {streak})")
        return {"status": "degraded" if reasons else "ok",
                "reasons": reasons, "mode": self.mode,
                "queue_depth": depth, "queue_capacity": cap,
                "models": self.registry.names()}

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

    @staticmethod
    def _not_ported(*_args):
        raise HttpError(501, _A8)

    def get_routes(self):
        routes = {"/healthz": self._healthz, "/metrics": self._metrics,
                  "/models": lambda: {"models": self.registry.summary()},
                  "/sessions": self._sessions}
        for path in ("/devices", "/flight", "/trace", "/series", "/slo"):
            routes[path] = self._not_ported
        return routes

    def get_prefix_routes(self):
        return {"/trace/": self._not_ported, "/flight/": self._not_ported}

    def post_routes(self):
        return {"/output": self._output, "/generate": self._generate,
                "/generate/cancel": self._generate_cancel,
                "/flight/dump": self._not_ported}

    def _given_up(self) -> bool:
        """True once a waiting handler should stop waiting: stop() aborted
        the decode sessions `stop_grace_s` ago."""
        t = self._stopped_at
        return t is not None and time.monotonic() - t >= self.stop_grace_s

    def stop(self):
        self.stop_listening()
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
