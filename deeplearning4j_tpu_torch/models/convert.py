"""Weight and optimizer-state conversion from the JAX package to the port.

The port keeps the JAX parameter names and orientation (`Wq` is
[n_in, d], applied as `x @ W`) and the JAX updater-state layout
(per layer `{"m": {...}, "v": {...}}` for Adam, `{"v": {...}}` for
Nesterovs, `()` for stateless updaters), so conversion is a checked
copy: every layer and key must match, with identical shapes. The caller
produces the tree on the JAX side as nested dicts of numpy arrays, e.g.
`jax.tree_util.tree_map(np.asarray, net.params_tree)`; this module never
imports jax. With both trees carried across, a trajectory resumes
mid-training in either package (the step count is `net.iteration`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_numpy(net, tree: Mapping[str, Mapping[str, np.ndarray]]):
    """Load a JAX net's `params_tree` (as numpy) into the port's `net`
    in place, cast to the net's dtype on its device. Raises KeyError on a
    missing or extra layer/parameter and ValueError on a shape mismatch.
    Returns `net`."""
    net._check_init()
    if set(tree) != set(net.params_tree):
        raise KeyError(f"layers differ: port {sorted(net.params_tree)}, "
                       f"given {sorted(tree)}")
    for lname, params in net.params_tree.items():
        src = tree[lname]
        if set(src) != set(params):
            raise KeyError(f"{lname}: parameters differ: port "
                           f"{sorted(params)}, given {sorted(src)}")
        for key, dst in params.items():
            arr = np.asarray(src[key])
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{lname}/{key}: shape {arr.shape} != "
                                 f"port's {tuple(dst.shape)}")
            dst.copy_(torch.tensor(arr, dtype=dst.dtype))
    return net


def _copy_tree(dst: Any, src: Any, path: str) -> None:
    """Copy nested numpy dicts into the same-shaped nested tensor dicts."""
    if isinstance(dst, dict):
        if not isinstance(src, Mapping) or set(src) != set(dst):
            got = sorted(src) if isinstance(src, Mapping) else type(src)
            raise KeyError(f"{path}: keys differ: port {sorted(dst)}, "
                           f"given {got}")
        for k, d in dst.items():
            _copy_tree(d, src[k], f"{path}/{k}")
        return
    if isinstance(dst, tuple) and not dst:
        if src not in ((), None) and not (
                isinstance(src, (tuple, list, Mapping)) and not src):
            raise KeyError(f"{path}: the port's updater is stateless, "
                           f"given {type(src).__name__}")
        return
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {arr.shape} != port's "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.tensor(arr, dtype=dst.dtype))


def updater_state_from_numpy(net, tree: Mapping[str, Any]):
    """Load a JAX net's `updater_state` (as numpy) into the port's `net`
    in place, with the checks of `params_from_numpy`: KeyError on a
    missing or extra layer or moment, ValueError on a shape mismatch.
    Returns `net`."""
    net._check_init()
    if set(tree) != set(net.updater_state):
        raise KeyError(f"layers differ: port {sorted(net.updater_state)}, "
                       f"given {sorted(tree)}")
    for lname, state in net.updater_state.items():
        _copy_tree(state, tree[lname], lname)
    return net
