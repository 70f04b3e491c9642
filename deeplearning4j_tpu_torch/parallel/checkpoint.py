"""Sharded, asynchronous training checkpoints with exact resume (port of
`deeplearning4j_tpu/parallel/checkpoint.py`, in the JAX package's
directory layout, so each package restores the other's params and
updater state).

- Each rank writes its `process-<k>/` directory: one `.npy` a unique
  slice it holds — a replicated tensor whole, a replica-sharded moment
  its 1/n — and a `manifest.json` naming each leaf's global shape,
  dtype and the [[lo, hi], ...] bounds of each file. bfloat16 leaves are
  written as 2-byte void records, as numpy writes the JAX package's.
- Asynchronous: `save()` copies the tensors to the host (the step
  updates them in place, so they must be copied before the next step);
  a daemon thread writes the files. A failed write is latched and
  raised by the next `wait()`, once.
- A step counts only once `COMMIT` exists in every rank's directory
  (written last, after the manifest): a kill mid-write never yields a
  half checkpoint. `fault_hook(kind, path)` runs before every file
  write ("shard" | "manifest" | "commit"): `parallel/chaos.py` kills the
  writer at an exact file boundary with it.
- Rotation keeps `max_to_keep` committed steps and never deletes one a
  restore has pinned.
- Restore reassembles every leaf's GLOBAL value from the committed
  shards of every rank and copies this rank's placement of it into the
  live tensors (in place: a captured CUDA graph and the fused updates'
  launch plans keep their addresses), so a snapshot written on N ranks
  restores onto M (`ReshardWitness` records it).
- The loop state rides along: iteration, epoch, the position inside the
  epoch, and the net's `torch.Generator` state, so a resume continues
  the same random stream. A JAX checkpoint's PRNG key has no torch
  counterpart: the port leaves its generator as it is, records
  `rng_not_restored` in the flight recorder and logs it, and never
  pretends to continue JAX's draws.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")

_MANIFEST = "manifest.json"
_COMMIT = "COMMIT"
_RNG_KIND = "torch.Generator"

__all__ = ["ShardedCheckpointer"]


# --------------------------------------------------------------- tree IO
def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        pass
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _dtype_name(t: torch.Tensor) -> str:
    """The dtype as numpy (and the JAX package's manifest) names it."""
    return "bfloat16" if t.dtype == torch.bfloat16 else \
        str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 as 2-byte void records (numpy's form of
    the JAX package's bfloat16 files)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view("V2").copy()
    return t.cpu().numpy().copy()


def _empty_global(shape, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        return np.empty(shape, dtype=np.uint16)
    return np.empty(shape, dtype=np.dtype(dtype))


def _load_file(path: str, dtype: str) -> np.ndarray:
    data = np.load(path)
    if dtype == "bfloat16":
        return data.view(np.uint16)
    return data


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == "bfloat16":
        return t.view(torch.bfloat16)
    return t


def _placement(net, name: str, key: str, leaf: torch.Tensor):
    """(global shape, this rank's [[lo, hi], ...]) of a leaf: from the
    net's placements when a `ParallelWrapper` holds it sharded, else
    the whole tensor."""
    pl = (getattr(net, "_placements", None) or {}).get(name, {}).get(key)
    if pl is not None:
        return list(pl[0]), [list(b) for b in pl[1]]
    shape = list(leaf.shape)
    return shape, [[0, d] for d in shape]


def _process():
    from deeplearning4j_tpu_torch.parallel.distributed import (
        process_count, process_index,
    )
    return process_index(), process_count()


# ------------------------------------------------------------ checkpointer
class ShardedCheckpointer:
    """Save/restore sharded training snapshots with rotation + async IO.

    `save()` returns as soon as the tensors are copied to the host;
    writing happens on a daemon thread. `restore_into()` rebuilds the
    model's trees (this rank's placements of them) and returns the loop
    position for exact resume."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        # the writer's error latch and the restore pins share one lock:
        # both cross threads (the writer appends and rotates, the main
        # thread drains and reads)
        self._state_lock = threading.Lock()
        self._errors: List[BaseException] = []
        self._pinned: set = set()
        # chaos seam: fn(kind, path) before every file write ("shard" |
        # "manifest" | "commit"); raising kills the writer there
        self.fault_hook: Optional[Any] = None

    # ------------------------------------------------------------- save
    def save(self, net, *, step: int, position: Optional[Dict] = None):
        """Snapshot params/updater/state + loop position at `step`."""
        payload, leaf_meta = {}, {}
        for name, tree in (("params", net.params_tree),
                           ("updater", net.updater_state),
                           ("state", net.state_tree)):
            payload[name], leaf_meta[name] = {}, {}
            for k, v in _flatten(tree).items():
                shape, bounds = _placement(net, name, k, v)
                payload[name][k] = [(bounds, _to_host(v))]
                leaf_meta[name][k] = {"shape": shape,
                                      "dtype": _dtype_name(v)}
        rng = getattr(net, "_rng", None)
        proc, nproc = _process()
        meta = {
            "step": int(step),
            "iteration": int(net.iteration),
            "epoch": int(net.epoch),
            "position": position or {},
            "rng": None if rng is None
            else rng.get_state().tolist(),
            "rng_kind": None if rng is None else _RNG_KIND,
            "process_index": proc,
            "process_count": nproc,
        }
        job = (payload, meta, leaf_meta)
        if self.async_save:
            self._ensure_worker()
            self._q.put(job)
        else:
            self._write(job)
        return self

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain, daemon=True, name="ckpt-writer")
            self._worker.start()

    def _drain(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                self._write(job)
            except BaseException as e:  # surfaced by wait()
                with self._state_lock:
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def _touch(self, kind: str, path: str) -> None:
        hook = self.fault_hook
        if hook is not None:
            hook(kind, path)

    def _write(self, job):
        payload, meta, leaf_meta = job
        step = meta["step"]
        proc = meta["process_index"]
        d = os.path.join(self.directory, f"step-{step:010d}")
        pdir = os.path.join(d, f"process-{proc}")
        os.makedirs(pdir, exist_ok=True)
        manifest = {"meta": meta, "leaves": {}}
        fid = 0
        for name, leaves in payload.items():
            for key, shards in leaves.items():
                entries = []
                for bounds, data in shards:
                    fn = f"s{fid:06d}.npy"
                    fid += 1
                    path = os.path.join(pdir, fn)
                    self._touch("shard", path)
                    np.save(path, data)
                    entries.append({"index": bounds, "file": fn})
                manifest["leaves"][f"{name}:{key}"] = {
                    "shards": entries, **leaf_meta[name][key]}
        mpath = os.path.join(pdir, _MANIFEST)
        self._touch("manifest", mpath)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        cpath = os.path.join(pdir, _COMMIT)
        self._touch("commit", cpath)
        with open(cpath, "w") as f:
            f.write("ok")
        self._rotate()

    def _rotate(self):
        with self._state_lock:
            pinned = set(self._pinned)
        for s in self.steps()[:-self.max_to_keep]:
            if s in pinned:
                # a restore is reading this step: deleting it under the
                # reader would lose the recovery
                continue
            shutil.rmtree(
                os.path.join(self.directory, f"step-{s:010d}"),
                ignore_errors=True)

    def wait(self):
        """Block until queued writes land; re-raise writer errors. The
        latch is drained on raise: one failed write surfaces once."""
        if self._worker is not None and self._worker.is_alive():
            self._q.join()
        with self._state_lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]
        return self

    # ---------------------------------------------------------- restore
    @staticmethod
    def _committed(d: str) -> bool:
        """Every rank the step was written by has committed it (one
        process: its COMMIT)."""
        want, done = None, 0
        for p in os.listdir(d):
            pdir = os.path.join(d, p)
            if not os.path.exists(os.path.join(pdir, _COMMIT)):
                continue
            done += 1
            if want is None:
                with open(os.path.join(pdir, _MANIFEST)) as f:
                    want = int(json.load(f)["meta"].get("process_count", 1))
        return want is not None and done >= want

    def steps(self) -> List[int]:
        out = []
        for n in os.listdir(self.directory):
            if not n.startswith("step-"):
                continue
            try:
                committed = self._committed(os.path.join(self.directory, n))
            except (OSError, ValueError, KeyError):
                # rotated away between the two listings, a stray entry,
                # or a manifest still being written: not a candidate
                continue
            if committed:
                out.append(int(n[len("step-"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _read_step(self, step: int):
        # pin the step for the read so rotation cannot delete it
        with self._state_lock:
            self._pinned.add(step)
        try:
            return self._read_step_pinned(step)
        finally:
            with self._state_lock:
                self._pinned.discard(step)

    def _read_step_pinned(self, step: int):
        d = os.path.join(self.directory, f"step-{step:010d}")
        flats: Dict[str, Dict[str, Tuple[np.ndarray, str]]] = {}
        meta = None
        try:
            pnames = sorted(os.listdir(d))
        except OSError:
            pnames = []
        for pname in pnames:
            pdir = os.path.join(d, pname)
            mf = os.path.join(pdir, _MANIFEST)
            if not os.path.exists(mf) or \
                    not os.path.exists(os.path.join(pdir, _COMMIT)):
                continue
            with open(mf) as f:
                manifest = json.load(f)
            meta = meta or manifest["meta"]
            for full_key, info in manifest["leaves"].items():
                name, key = full_key.split(":", 1)
                dtype = info["dtype"]
                tgt = flats.setdefault(name, {})
                if key not in tgt:
                    tgt[key] = (_empty_global(tuple(info["shape"]), dtype),
                                dtype)
                for entry in info["shards"]:
                    data = _load_file(os.path.join(pdir, entry["file"]),
                                      dtype)
                    idx = tuple(slice(lo, hi) for lo, hi in entry["index"])
                    tgt[key][0][idx] = data
        if meta is None:
            raise FileNotFoundError(
                f"No committed checkpoint for step {step} in {self.directory}")
        return flats, meta

    def restore_into(self, net, *, step: Optional[int] = None) -> Dict:
        """Load a checkpoint into a model: each leaf's global value,
        sliced to this rank's placement (the net's `_placements` under a
        `ParallelWrapper`), copied into the live tensor. Returns the loop
        position."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        flats, meta = self._read_step(step)
        moved = 0
        for name, tree in (("params", net.params_tree),
                           ("updater", net.updater_state),
                           ("state", net.state_tree)):
            if name not in flats or not tree:
                continue
            saved = flats[name]
            for key, leaf in _flatten(tree).items():
                if key not in saved:
                    continue
                arr, dtype = saved[key]
                shape, bounds = _placement(net, name, key, leaf)
                if list(arr.shape) != list(shape):
                    raise ValueError(
                        f"checkpoint leaf {name}:{key} has shape "
                        f"{list(arr.shape)}, the net's is {list(shape)}")
                part = arr[tuple(slice(lo, hi) for lo, hi in bounds)]
                src = _to_tensor(part, dtype)
                with torch.no_grad():
                    leaf.copy_(src.to(leaf.dtype))
                moved += part.nbytes
        net.iteration = int(meta["iteration"])
        net.epoch = int(meta["epoch"])
        self._restore_rng(net, meta)
        self._witness_reshard(net, meta, moved)
        return dict(meta["position"])

    @staticmethod
    def _restore_rng(net, meta) -> None:
        rng = getattr(net, "_rng", None)
        if meta.get("rng") is None or rng is None:
            return
        if meta.get("rng_kind") == _RNG_KIND:
            rng.set_state(torch.tensor(meta["rng"], dtype=torch.uint8))
            return
        # a JAX PRNG key: no torch stream continues it
        from deeplearning4j_tpu_torch.observe.flight import get_flight
        get_flight().record("rng_not_restored", iteration=int(
            meta["iteration"]), key=list(meta["rng"])[:8])
        logger.warning(
            "checkpoint holds a JAX PRNG key, which no torch generator "
            "continues: the net's generator keeps its own stream")

    @staticmethod
    def _witness_reshard(net, meta, moved: int) -> None:
        """A restore onto another rank count is an explicit reshard."""
        _, nproc = _process()
        src = int(meta.get("process_count", 1))
        if src == nproc:
            return
        from deeplearning4j_tpu_torch.observe.commsmon import (
            get_reshard_witness,
        )
        wit = get_reshard_witness()
        if wit is not None:
            wit.record_reshard(
                type(net).__name__, "restore",
                leaves=len(_flatten(net.updater_state)),
                payload_bytes=moved, from_ranks=src, to_ranks=nproc)

    def restore_into_wrapper(self, wrapper, *,
                             step: Optional[int] = None) -> Dict:
        """Restore into a ParallelWrapper's model with ITS placements:
        the replica-sharded moments land as this rank's slices. The
        wrapper may run on another rank count than the snapshot's
        (elastic shrink/grow): `_read_step` reassembles each global
        value from the saved shards, and this rank takes its slice."""
        return self.restore_into(wrapper.net, step=step)
