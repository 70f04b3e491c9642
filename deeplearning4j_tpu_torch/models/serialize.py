"""Model files: the zip container of `deeplearning4j_tpu/models/serialize.py`,
readable and written the same way by both packages.

Reference parity: `util/ModelSerializer.java:37-119`. The zip holds
`configuration.json` (the configuration's JSON), `coefficients.npz`
(the params tree), `netState.npz` (the state tree: batch-norm running
statistics), `updaterState.npz` (the optimizer moments) and
`metadata.json` (format version, model class, iteration, epoch). Each
npz is keyed by the tree's path, `layer/param` (`layer/m/W` for a
moment), the JAX package's flattening, so a file saved by either package
loads in the other.

bfloat16 leaves: numpy has no bfloat16, and the JAX package writes such
a leaf as its raw 2-byte words (a void `'<V2'` array). The port writes
the same bits (`'|V2'`, the same bytes under numpy's portable spelling of
a 2-byte void) and, on load, reinterprets a 2-byte void leaf as bfloat16
wherever the net's own leaf is bfloat16. So the port loads the JAX
package's bfloat16 files, which that package's own `load_model` refuses
(ROADMAP C8).

A loaded net resumes where the file left it: `iteration` and `epoch`
come from the metadata, and the next `fit` starts its device step
counter (Adam's bias correction, a schedule's rate) from `iteration`.

Sharded checkpoints: `CheckpointManager` (Orbax in the JAX package)
runs on `parallel.ShardedCheckpointer` in the port.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

FORMAT_VERSION = 1

_CONFIG_JSON = "configuration.json"
_COEFFICIENTS = "coefficients.npz"
_UPDATER_STATE = "updaterState.npz"
_NET_STATE = "netState.npz"
_METADATA = "metadata.json"


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _tree_to_flat_dict(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tree_to_flat_dict(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_tree_to_flat_dict(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix.rstrip("/")] = _leaf_to_numpy(tree)
    return out


def _leaf_from_numpy(arr: np.ndarray, like: torch.Tensor,
                     key: str) -> torch.Tensor:
    """A file's leaf as a tensor in `like`'s dtype on its device; a
    2-byte void leaf is bfloat16 bits and loads only into a bfloat16
    leaf."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise ValueError(f"{key}: raw {arr.dtype} leaf in the file, "
                             f"but the net's leaf is {like.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} in the file, the "
                         f"net's is {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def _flat_dict_to_tree(flat: Dict[str, np.ndarray], like) -> Any:
    """Rebuild a tree with `like`'s structure from path-keyed arrays;
    a leaf the file lacks keeps `like`'s value."""
    def rebuild(sub, prefix):
        if isinstance(sub, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            vals = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(sub)]
            return type(sub)(vals)
        key = prefix.rstrip("/")
        if key in flat and sub is not None:
            return _leaf_from_numpy(flat[key], sub, key)
        return sub
    return rebuild(like, "")


def _save_npz(zf: zipfile.ZipFile, name: str, tree) -> None:
    flat = _tree_to_flat_dict(tree)
    buf = io.BytesIO()
    np.savez(buf, **flat) if flat else np.savez(buf, __empty__=np.zeros(0))
    zf.writestr(name, buf.getvalue())


def _load_npz(zf: zipfile.ZipFile, name: str) -> Dict[str, np.ndarray]:
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        return {k: data[k] for k in data.files if k != "__empty__"}


def save_model(net, path: Union[str, os.PathLike], *,
               save_updater: bool = True) -> None:
    """Write `net` (a MultiLayerNetwork or ComputationGraph, on any
    device) to the zip at `path`. Reference: `ModelSerializer.writeModel`."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph,
    )

    net._check_init()
    cls = ("ComputationGraph" if isinstance(net, ComputationGraph)
           else "MultiLayerNetwork")
    meta = {
        "format_version": FORMAT_VERSION,
        "model_class": cls,
        "iteration": int(net.iteration),
        "epoch": int(net.epoch),
        "framework": "deeplearning4j_tpu_torch",
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_CONFIG_JSON, net.conf.to_json())
        _save_npz(zf, _COEFFICIENTS, net.params_tree)
        _save_npz(zf, _NET_STATE, net.state_tree)
        if save_updater and net.updater_state is not None:
            _save_npz(zf, _UPDATER_STATE, net.updater_state)
        zf.writestr(_METADATA, json.dumps(meta, indent=2))


def load_model(path: Union[str, os.PathLike], *, device=None,
               load_updater: bool = True):
    """Read a model zip written by either package onto `device` (CUDA
    unless the caller passes "cpu"): the class from the metadata, the
    configuration from its JSON, then the trees, `iteration` and `epoch`.
    Reference: `ModelSerializer.restoreMultiLayerNetwork` /
    `restoreComputationGraph`."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph,
    )
    from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraphConfiguration,
    )

    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read(_METADATA))
        config_json = zf.read(_CONFIG_JSON).decode()
        if meta["model_class"] == "ComputationGraph":
            net = ComputationGraph(
                ComputationGraphConfiguration.from_json(config_json),
                device=device)
        else:
            net = MultiLayerNetwork(
                MultiLayerConfiguration.from_json(config_json),
                device=device)
        net.init()
        names = zf.namelist()
        net.params_tree = _flat_dict_to_tree(_load_npz(zf, _COEFFICIENTS),
                                             net.params_tree)
        if _NET_STATE in names:
            net.state_tree = _flat_dict_to_tree(_load_npz(zf, _NET_STATE),
                                                net.state_tree)
        if load_updater and _UPDATER_STATE in names:
            net.updater_state = _flat_dict_to_tree(
                _load_npz(zf, _UPDATER_STATE), net.updater_state)
        net.iteration = int(meta.get("iteration", 0))
        net.epoch = int(meta.get("epoch", 0))
    return net


class CheckpointManager:
    """Asynchronous checkpoints with rotation, the JAX package's API
    (`save(step, net)`, `restore(net, step=None)`, `wait()`, `close()`).
    The JAX package's is built on Orbax, which the port does not have;
    the port's is built on `parallel.ShardedCheckpointer`, so its
    directory holds that checkpointer's `step-<n>/process-<k>/` layout,
    not Orbax's: the two packages' directories differ here. Params,
    updater state, layer state, iteration and epoch round-trip, each
    rank's placement of them under a `ParallelWrapper`."""

    def __init__(self, directory, *, max_to_keep: int = 3,
                 async_save: bool = True):
        from deeplearning4j_tpu_torch.parallel.checkpoint import (
            ShardedCheckpointer,
        )

        self.directory = os.path.abspath(directory)
        self._ckpt = ShardedCheckpointer(self.directory,
                                         max_to_keep=max_to_keep,
                                         async_save=async_save)

    def save(self, step: int, net) -> None:
        self._ckpt.save(net, step=int(step))

    def restore(self, net, step: Optional[int] = None):
        self._ckpt.restore_into(net, step=step)
        return net

    def wait(self):
        self._ckpt.wait()

    def close(self):
        self._ckpt.wait()
