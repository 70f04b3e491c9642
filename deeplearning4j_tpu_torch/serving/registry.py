"""ModelRegistry — named, versioned models behind one server, with
atomic hot-swap (port of `deeplearning4j_tpu/serving/registry.py`).

The registry owns each deployed model's data plane, a
`ParallelInference` runner (pad to a batch bucket, one `output()` a
bucket, chunks past the largest), and is the scheduler's
`acquire()/release()` seam. `deploy(name, version, net)`:

1. builds the new entry's runner and warms it (one forward at every
   bucket) while the old version keeps serving. The warm-up is the
   canary: if it raises, or it trips the recompile watchdog on the new
   runner's tag (the version would pay a bucket's first forward under
   live traffic, `observe/watchdog.py`), the flip never happens, the
   previous version keeps serving and `DeployRolledBackError` is raised;
   the rollback is counted in `serving_deploy_rollbacks_total` and
   flight-recorded. A watchdog trip on a FIRST deploy (nothing to roll
   back to) proceeds with a warning — degraded beats dark. Deploy hooks
   then run their "warm" phase (a decode-session manager checks that
   its live sessions can move onto the candidate and runs the
   candidate's session programs once); a hook that raises rolls the
   deploy back the same way;
2. flips the active pointer under the registry lock, atomic with
   `acquire`, so a request routes to exactly one version; "flipped"
   hooks run next (the session manager rebinds its pool: live sessions
   continue on the new weights);
3. drains the old entry (waits for its in-flight batches) and shuts its
   runner down.

External runners (the decode session manager) join through
`register_entry`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceMode, ParallelInference,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")


class DeployRolledBackError(RuntimeError):
    """`deploy()` refused to flip: the warm-up raised or tripped the
    recompile watchdog, or a warm-phase hook raised, and the previously
    active version (when one exists) was left serving. The failed runner
    is already shut down."""


class ModelEntry:
    """One deployed (name, version): net + warmed runner + in-flight
    accounting for drain-on-swap."""

    def __init__(self, name: str, version, net, runner):
        self.name = name
        self.version = version
        self.net = net
        self.runner = runner
        self.deployed_at = time.time()
        self.served = 0
        self._inflight = 0
        self._cv = threading.Condition()
        self._retired = False
        self._external = False

    def run_batch(self, xs):
        return self.runner.run_batch(xs)

    def output(self, x):
        """Collect and direct modes: through the runner's collector queue
        when it is BATCHED, a direct call otherwise."""
        return self.runner.output(x)

    def _drain(self, timeout: Optional[float]) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0, timeout)

    def describe(self) -> dict:
        with self._cv:
            return {"version": self.version,
                    "deployed_at": round(self.deployed_at, 3),
                    "served": self.served,
                    "inflight": self._inflight,
                    "retired": self._retired}


class ModelRegistry:
    """Named models, one active version each, atomic hot-swap."""

    def __init__(self, *, mesh=None, max_batch_size: int = 64,
                 batch_buckets: Optional[List[int]] = None,
                 runner_mode: str = InferenceMode.INPLACE,
                 collect_wait_ms: float = 5.0,
                 drain_timeout_s: float = 30.0):
        self.mesh = mesh
        self.max_batch = max_batch_size
        self.buckets = batch_buckets
        self.runner_mode = runner_mode
        self.collect_wait_ms = collect_wait_ms
        self.drain_timeout = drain_timeout_s
        self._lock = threading.Lock()
        self._active: Dict[str, ModelEntry] = {}
        self._history: Dict[str, List] = {}
        self._deploy_hooks: Dict[str, List] = {}

    # ---------------------------------------------------------- deploy
    @staticmethod
    def _infer_feat_shape(net):
        """The single-input feature shape for the warm-up, from the
        config's input type (None when it has none or a free length)."""
        it = getattr(getattr(net, "conf", None), "input_type", None)
        if it is None:
            return None
        shape = it.shape(1)[1:]
        return shape if all(shape) else None

    def deploy(self, name: str, version, net, *, feat_shape=None,
               warm: bool = True) -> ModelEntry:
        """Deploy `net` as the active version of `name`; returns the new
        entry after the old one (if any) is drained and retired. With
        `warm`, the runner's warm-up and the warm-phase hooks are the
        canary: if either raises, or the warm-up trips the recompile
        watchdog while a previous version serves, nothing flips and
        DeployRolledBackError is raised."""
        with self._lock:
            cur = self._active.get(name)
        if cur is not None and cur._external:
            raise ValueError(
                f"{name!r} is an externally-managed entry "
                f"(register_entry); deploy() cannot replace it")
        runner = ParallelInference(
            net, mesh=self.mesh, mode=self.runner_mode,
            max_batch_size=self.max_batch, batch_buckets=self.buckets,
            max_wait_ms=self.collect_wait_ms)
        entry = ModelEntry(name, version, net, runner)
        if warm:
            shape = feat_shape or self._infer_feat_shape(net)
            if shape:
                try:
                    runner.warmup(shape)
                except Exception as e:
                    self._reject_deploy(name, version, runner, cause=e)
                if self._warmup_tripped(runner):
                    with self._lock:
                        has_previous = name in self._active
                    if has_previous:
                        self._reject_deploy(name, version, runner,
                                            cause=None)
                    logger.warning(
                        "deploy(%s@%r): warmup tripped the recompile "
                        "watchdog but no previous version exists — "
                        "deploying anyway (degraded beats dark)",
                        name, version)
            for hook in self._hooks_for(name):
                try:
                    hook("warm", name, version, net)
                except Exception as e:
                    self._reject_deploy(name, version, runner, cause=e)
        with self._lock:
            old = self._active.get(name)
            self._active[name] = entry
            self._history.setdefault(name, []).append(
                {"version": version, "at": round(time.time(), 3)})
        # flipped hooks run after the pointer swap and before the old
        # entry drains; the flip already happened, so a failure is logged
        for hook in self._hooks_for(name):
            try:
                hook("flipped", name, version, net)
            except Exception as e:
                logger.exception("deploy(%s@%r): post-flip hook failed",
                                 name, version)
                from deeplearning4j_tpu_torch.observe import get_flight

                get_flight().record("deploy_hook_failed", model=name,
                                    version=version,
                                    error=type(e).__name__)
        if old is not None:
            self._retire(old)
        return entry

    @staticmethod
    def _warmup_tripped(runner: ParallelInference) -> bool:
        """Did warming THIS runner cross the watchdog's churn threshold?
        The tag is per instance, so a trip here is the new version's own
        churn, never residue from an old one."""
        from deeplearning4j_tpu_torch.observe.watchdog import get_watchdog

        return get_watchdog().warned(runner.owner_tag)

    def _reject_deploy(self, name, version, runner, *, cause):
        """Tear down the failed candidate and raise; the active pointer
        was never touched, so the old version (if any) keeps serving.
        `cause` None: the warm-up tripped the watchdog."""
        runner.shutdown()
        from deeplearning4j_tpu_torch.observe import get_flight, get_registry

        reason = (f"warm-up raised {type(cause).__name__}: {cause}"
                  if cause is not None
                  else "warmup tripped the recompile watchdog")
        with self._lock:
            has_previous = name in self._active
        get_registry().counter("serving_deploy_rollbacks_total",
                               model=name).inc()
        get_flight().record(
            "deploy_rollback", model=name, version=version,
            reason=reason, watchdog_tripped=cause is None,
            previous_kept=has_previous,
            error=None if cause is None else type(cause).__name__)
        logger.warning("deploy(%s@%r) rolled back: %s%s", name, version,
                       reason, " — previous version keeps serving"
                       if has_previous else "")
        raise DeployRolledBackError(
            f"deploy {name}@{version!r} rolled back: {reason}") from cause

    # ---------------------------------------------- entries and hooks
    def register_entry(self, name: str, entry: ModelEntry) -> ModelEntry:
        """Register an externally-managed entry (a decode-session
        endpoint whose runner is a session manager): it takes part in
        acquire/release/summary/close, but `deploy()` under its name is
        refused."""
        with self._lock:
            if name in self._active:
                raise ValueError(f"entry {name!r} already registered")
            entry._external = True
            self._active[name] = entry
            self._history.setdefault(name, []).append(
                {"version": entry.version, "at": round(time.time(), 3)})
        return entry

    def add_deploy_hook(self, name: str, hook) -> None:
        """Subscribe `hook(phase, name, version, net)` to deploys of
        `name`: phase "warm" (inside the canary, before the flip; raising
        rolls the deploy back) or "flipped" (after the flip; failures are
        logged, never raised)."""
        with self._lock:
            self._deploy_hooks.setdefault(name, []).append(hook)

    def remove_deploy_hook(self, name: str, hook) -> None:
        with self._lock:
            hooks = self._deploy_hooks.get(name, [])
            if hook in hooks:
                hooks.remove(hook)

    def _hooks_for(self, name: str) -> List:
        with self._lock:
            return list(self._deploy_hooks.get(name, []))

    def undeploy(self, name: str):
        with self._lock:
            old = self._active.pop(name)
        self._retire(old)

    def _retire(self, entry: ModelEntry):
        entry._drain(self.drain_timeout)
        with entry._cv:
            entry._retired = True
        entry.runner.shutdown()

    # ------------------------------------------------- scheduler SPI
    def acquire(self, name: str) -> ModelEntry:
        """Pin the active entry for one dispatch (KeyError for unknown
        models). Atomic with deploy's flip (same lock)."""
        with self._lock:
            entry = self._active[name]
            with entry._cv:
                entry._inflight += 1
                entry.served += 1
        return entry

    def release(self, entry: ModelEntry):
        with entry._cv:
            entry._inflight -= 1
            entry._cv.notify_all()

    # ------------------------------------------------------- inspection
    def get(self, name: str) -> ModelEntry:
        with self._lock:
            return self._active[name]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._active)

    def summary(self) -> dict:
        """/models payload."""
        with self._lock:
            entries = dict(self._active)
            history = {n: list(h) for n, h in self._history.items()}
        return {name: dict(entry.describe(),
                           deployments=len(history.get(name, ())))
                for name, entry in sorted(entries.items())}

    def close(self):
        with self._lock:
            entries = list(self._active.values())
            self._active.clear()
        for e in entries:
            self._retire(e)
