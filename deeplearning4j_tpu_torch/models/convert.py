"""Weight and optimizer-state conversion from the JAX package to the port.

The port keeps the JAX parameter names and orientation (`Wq` is
[n_in, d], applied as `x @ W`) and the JAX updater-state layout
(per layer `{"m": {...}, "v": {...}}` for Adam, `{"v": {...}}` for
Nesterovs, `()` for stateless updaters), so conversion is a checked
copy: every layer and key must match, with identical shapes. The caller
produces the tree on the JAX side as nested dicts of numpy arrays, e.g.
`jax.tree_util.tree_map(np.asarray, net.params_tree)`; this module never
imports jax. A ComputationGraph's trees are keyed by vertex name (a
parameterless vertex has an empty dict) and load the same way; its
batch-norm and fused conv+BN running statistics are `state_tree`,
loaded by `state_from_numpy`. With the trees carried across, a
trajectory resumes mid-training in either package (the step count is
`net.iteration`).

The pretrainable and special layers load the same way: a `FrozenLayer`'s
tree is its inner layer's, the variational autoencoder's is nested
(`enc` / `dec` blocks "0", "1", ... of `W` and `b`, then `mu`, `logvar`
and `rec`), an RBM's is `W`, `hb`, `vb`, an AutoEncoder's `W`, `b`, `vb`,
and a `CenterLossOutputLayer`'s class centers are its `state_tree`
entry (`centers`, [n_out, n_in]), loaded by `state_from_numpy`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_numpy(net, tree: Mapping[str, Any], *,
                      partial: bool = False, resize=()):
    """Load a JAX net's `params_tree` (as numpy) into the port's `net`
    in place, cast to the net's dtype on its device. The LSTM leaves (`W`
    [n_in, 4H], `RW` [H, 4H], `b` [4H], `P` [3, H]) have the same layout
    in both packages, and the bidirectional wrappers' nested `fwd`/`bwd`
    trees copy as they are. Raises KeyError on a missing or extra
    layer/parameter and ValueError on a shape mismatch. With `partial`
    (an importer's arrays) `tree` may leave out layers and keys, which
    keep their values; a key named in `resize` (a Keras PReLU's alpha,
    which keeps Keras's shape) may take another shape, as a new tensor
    of the net's dtype on its device. Returns `net`."""
    net._check_init()
    _copy_layers(net.params_tree, tree, partial, frozenset(resize),
                 net.dtype)
    return net


def _copy_layers(dst: Mapping[str, Any], tree: Mapping[str, Any],
                 partial: bool = False, resize: frozenset = frozenset(),
                 dtype=None) -> None:
    """`_copy_tree` of each layer of `tree` into its entry of `dst`."""
    if not (set(tree) <= set(dst) if partial else set(tree) == set(dst)):
        raise KeyError(f"layers differ: port {sorted(dst)}, "
                       f"given {sorted(tree)}")
    for lname, src in tree.items():
        _copy_tree(dst[lname], src, lname, partial, resize, dtype)


@torch.no_grad()
def _copy_tree(dst: Any, src: Any, path: str, partial: bool = False,
               resize: frozenset = frozenset(), dtype=None) -> None:
    """Copy nested numpy dicts into the same-shaped nested tensor dicts
    (`params_from_numpy`'s `partial` and `resize`)."""
    if isinstance(dst, dict):
        if not isinstance(src, Mapping) or not (
                set(src) <= set(dst) if partial else set(src) == set(dst)):
            got = sorted(src) if isinstance(src, Mapping) else type(src)
            raise KeyError(f"{path}: keys differ: port {sorted(dst)}, "
                           f"given {got}")
        for k, v in src.items():
            d = dst[k]
            if k in resize and isinstance(d, torch.Tensor) and \
                    tuple(np.shape(v)) != tuple(d.shape):
                dst[k] = torch.tensor(np.asarray(v), dtype=dtype or d.dtype,
                                      device=d.device)
                continue
            _copy_tree(d, v, f"{path}/{k}", partial, resize, dtype)
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
    _copy_layers(net.updater_state, tree)
    return net


def state_from_numpy(net, tree: Mapping[str, Any], *,
                     partial: bool = False):
    """Load a JAX net's `state_tree` (as numpy) into the port's `net` in
    place: the running mean/var of `BatchNormalization` (in the net's
    dtype) and of `FusedConvBNLayer` (float32), each cast to the port
    tensor's own dtype. Vertices or layers without state are empty dicts
    on both sides. Checks and `partial` as `params_from_numpy`. Returns
    `net`."""
    net._check_init()
    _copy_layers(net.state_tree, tree, partial)
    return net
