"""ReplicaServer — one fleet member: an InferenceServer plus the
`/fleet/*` control surface the router drives (port of
`deeplearning4j_tpu/serving/fleet/replica.py`).

A replica declares a ROLE at launch:

  prefill — admits prefill-only sessions (`POST /fleet/prefill`): the
            prompt stem runs through chunked prefill into the paged
            pool, the pages are indexed in the radix, and the warm
            stem is exported as a handoff payload. No decode windows.
  decode  — imports handed-off pages (`POST /fleet/kv/import`) so the
            very next `/generate` admission matches the whole stem and
            goes straight to the decode window.
  mixed   — both (the default; a one-replica fleet is just a server).

The role is ROUTING metadata: every replica carries the full machinery
and the router chooses what to send where. Draining is advisory the
same way — the router stops placing new sessions here, and the replica
backs it up by refusing new `/generate` admissions with 503 while
in-flight streams run to completion (drain is a migration, never a
drop).

Coordinated hot-swap: `POST /fleet/deploy` ships a declarative model
SPEC (not weights — replicas rebuild deterministically via a
registered builder, the same discipline as the replica-main models),
and the reply distinguishes a clean flip from a deploy
watchdog trip (`DeployRolledBackError` → `rolled_back: true`) so the
router can roll the rest of the fleet back to the previous spec.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np

from deeplearning4j_tpu_torch.observe import reqtrace
from deeplearning4j_tpu_torch.serving.http_base import HttpError
from deeplearning4j_tpu_torch.serving.inference_server import (
    DEFAULT_MODEL, InferenceServer,
)
from deeplearning4j_tpu_torch.serving.kv_pool import (
    IncompatibleSessionSwapError, SlotPoolExhaustedError,
)
from deeplearning4j_tpu_torch.serving.registry import DeployRolledBackError
from deeplearning4j_tpu_torch.serving.fleet import handoff

ROLES = ("prefill", "decode", "mixed")

# name -> callable(spec dict) -> net. Replica processes and tests
# register builders at startup; a fleet deploy ships `{"kind": name,
# ...params}` and every replica rebuilds the same net deterministically
# (seeded init), which is what makes cross-replica greedy decode
# bit-exact without ever moving weight bytes over the wire.
_MODEL_BUILDERS: Dict[str, Callable[[dict], object]] = {}


def register_model_builder(kind: str,
                           fn: Callable[[dict], object]) -> None:
    _MODEL_BUILDERS[kind] = fn


def build_from_spec(spec: dict):
    kind = spec.get("kind")
    fn = _MODEL_BUILDERS.get(kind)
    if fn is None:
        raise ValueError(
            f"no model builder registered for kind {kind!r} "
            f"(have {sorted(_MODEL_BUILDERS)})")
    return fn(spec)


class ReplicaServer(InferenceServer):
    """InferenceServer + fleet role, drain flag, KV handoff endpoints,
    and spec-driven coordinated deploy."""

    def __init__(self, *args, role: str = "mixed",
                 replica_name: str = "replica", **kw):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        super().__init__(*args, **kw)
        self.role = role
        self.replica_name = replica_name
        self.draining = False

    # ----------------------------------------------------------- helpers
    def _mgr(self, model: str):
        mgr = self._decode.get(model)
        if mgr is None:
            raise HttpError(
                400, f"decode sessions are not enabled for {model!r}")
        return mgr

    def _paged_mgr(self, model: str):
        mgr = self._mgr(model)
        if not getattr(mgr, "prefix_enabled", False):
            raise HttpError(
                400, f"model {model!r} has no paged prefix cache — KV "
                f"handoff needs page_len and the radix index")
        return mgr

    @staticmethod
    def _prompt(req: dict, field: str = "prompt_ids") -> np.ndarray:
        try:
            prompt = np.asarray(req[field], dtype=np.int64).reshape(-1)
        except KeyError:
            raise
        except Exception as e:
            raise HttpError(400, f"bad {field}: {e}")
        if prompt.size < 1:
            raise HttpError(400, f"{field} must be non-empty")
        return prompt

    # ------------------------------------------------------ fleet routes
    def _fleet_info(self):
        decode = {}
        for model, mgr in self._decode.items():
            d = {"slots": mgr.pool.slots,
                 "slots_in_use": mgr.pool.in_use()}
            if getattr(mgr, "prefix_enabled", False):
                with mgr.pool.lock():
                    d["prefix"] = mgr.prefix_cache.stats()
                d["kv"] = mgr.pool.describe()
            decode[model] = d
        return {"name": self.replica_name, "role": self.role,
                "draining": self.draining,
                "models": self.registry.names(),
                "decode": decode}

    def _fleet_drain(self, req: dict):
        self.draining = bool(req.get("draining", True))
        return {"name": self.replica_name, "draining": self.draining}

    def _fleet_prefill(self, req: dict):
        """Run a prefill-only session and return the warm stem as a
        handoff payload — the prefill half of a disaggregated request."""
        model = req.get("model", DEFAULT_MODEL)
        mgr = self._paged_mgr(model)
        prompt = self._prompt(req)
        rt = reqtrace.new_trace("fleet.prefill")
        t0 = time.monotonic()
        try:
            sess = mgr.open_prefill(
                prompt, deadline_ms=req.get("deadline_ms"),
                alloc_timeout_s=float(req.get("alloc_timeout_s", 0.0)),
                trace=rt)
        except SlotPoolExhaustedError as e:
            reqtrace.finish_root(rt, route="/fleet/prefill", status=503)
            raise HttpError(503, f"no free prefill slot: {e}")
        except (TypeError, ValueError) as e:
            reqtrace.finish_root(rt, route="/fleet/prefill", status=400)
            raise HttpError(400, str(e))
        try:
            sess.result(timeout=60.0)
        except BaseException as e:
            reqtrace.finish_root(rt, route="/fleet/prefill", status=500)
            raise HttpError(500, f"prefill failed: {e}")
        payload = handoff.export_prefix(mgr.pool, mgr.prefix_cache,
                                        prompt[:-1], model=model)
        out = {"session": sess.id, "model": model,
               "replica": self.replica_name,
               "prefill_ms": (time.monotonic() - t0) * 1000.0,
               "payload": payload}
        if rt is not None:
            reqtrace.finish_root(
                rt, route="/fleet/prefill", model=model,
                prompt_len=int(prompt.size),
                cached_len=0 if payload is None
                else payload["cached_len"])
            out["trace_id"] = rt.trace_id
        return out

    def _fleet_kv_export(self, req: dict):
        """Serialize the longest cached prefix of `tokens` (drain
        migration: the router pulls a session's warm stem out of a
        draining replica)."""
        model = req.get("model", DEFAULT_MODEL)
        mgr = self._paged_mgr(model)
        tokens = self._prompt(req, "tokens")
        payload = handoff.export_prefix(mgr.pool, mgr.prefix_cache,
                                        tokens, model=model)
        return {"model": model, "replica": self.replica_name,
                "payload": payload}

    def _fleet_kv_import(self, req: dict):
        model = req.get("model", DEFAULT_MODEL)
        mgr = self._paged_mgr(model)
        payload = req.get("payload")
        if not isinstance(payload, dict):
            raise HttpError(400, "missing handoff payload")
        try:
            cached_len = handoff.install_prefix(
                mgr.pool, mgr.prefix_cache, payload)
        except handoff.HandoffError as e:
            raise HttpError(400, str(e))
        except SlotPoolExhaustedError as e:
            raise HttpError(503, f"no free pages for import: {e}")
        return {"model": model, "replica": self.replica_name,
                "cached_len": cached_len,
                "bytes": handoff.payload_bytes(payload)}

    def _fleet_deploy(self, req: dict):
        """Deploy one named target from a declarative spec. Never raises
        for a deploy-shaped failure — the router needs the structured
        verdict (`rolled_back` / `incompatible`) to coordinate the
        fleet-wide rollback."""
        name = req.get("name", DEFAULT_MODEL)
        version = req.get("version")
        spec = req.get("spec")
        if version is None or not isinstance(spec, dict):
            raise HttpError(400, "deploy needs {name, version, spec}")
        try:
            net = build_from_spec(spec)
        except Exception as e:
            raise HttpError(400, f"bad model spec: {e}")
        try:
            self.registry.deploy(name, version, net,
                                 warm=bool(req.get("warm", True)))
        except DeployRolledBackError as e:
            return {"ok": False, "rolled_back": True,
                    "replica": self.replica_name, "name": name,
                    "error": str(e)}
        except IncompatibleSessionSwapError as e:
            return {"ok": False, "rolled_back": True,
                    "incompatible": True,
                    "replica": self.replica_name, "name": name,
                    "error": str(e)}
        return {"ok": True, "replica": self.replica_name,
                "name": name, "version": version}

    # ----------------------------------------------- admission override
    def _generate(self, req: dict):
        if self.draining and not req.get("_migration", False):
            # belt-and-braces behind the router's own bookkeeping: a
            # draining replica takes no NEW sessions (503 → the router
            # places elsewhere) while live streams run to completion
            raise HttpError(503,
                            f"replica {self.replica_name} is draining")
        return super()._generate(req)

    def get_routes(self):
        routes = dict(super().get_routes())
        routes["/fleet/info"] = self._fleet_info
        return routes

    def post_routes(self):
        routes = dict(super().post_routes())
        routes.update({
            "/fleet/prefill": self._fleet_prefill,
            "/fleet/kv/export": self._fleet_kv_export,
            "/fleet/kv/import": self._fleet_kv_import,
            "/fleet/drain": self._fleet_drain,
            "/fleet/deploy": self._fleet_deploy,
        })
        return routes
