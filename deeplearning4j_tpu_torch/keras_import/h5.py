"""HDF5 archive access for Keras checkpoints (a copy of
`deeplearning4j_tpu/keras_import/h5.py`, which needs only numpy and
h5py; h5py is imported when a file is opened).

Reference parity: `Hdf5Archive.java:22-35` (JavaCPP hdf5 → h5py here):
model config JSON from root attrs, per-layer weight groups under
`model_weights/` (Keras 2) or the root (Keras 1).
"""

from __future__ import annotations

import json
from typing import List

import numpy as np


class Hdf5Archive:
    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "r")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @staticmethod
    def _decode(v) -> str:
        if isinstance(v, bytes):
            return v.decode("utf-8")
        return str(v)

    def model_config(self) -> dict:
        """The training config JSON (reference: readAttributeAsJson)."""
        if "model_config" not in self._f.attrs:
            raise ValueError("No 'model_config' attribute — not a Keras "
                             "model file saved with model.save()")
        return json.loads(self._decode(self._f.attrs["model_config"]))

    def keras_version(self) -> str:
        root = self._weights_root()
        for holder in (self._f, root):
            if holder is not None and "keras_version" in holder.attrs:
                return self._decode(holder.attrs["keras_version"])
        return "1"

    def _weights_root(self):
        if "model_weights" in self._f:
            return self._f["model_weights"]
        return self._f

    def layer_names(self) -> List[str]:
        root = self._weights_root()
        if "layer_names" in root.attrs:
            return [self._decode(n) for n in root.attrs["layer_names"]]
        return list(root.keys())

    def layer_weights(self, layer_name: str) -> List[np.ndarray]:
        """Ordered weight arrays for a layer (kernel first, then bias...)."""
        root = self._weights_root()
        if layer_name not in root:
            return []
        grp = root[layer_name]
        if "weight_names" in grp.attrs:
            names = [self._decode(n) for n in grp.attrs["weight_names"]]
        else:
            names = []

            def collect(g, prefix=""):
                for k in g:
                    item = g[k]
                    if hasattr(item, "keys"):
                        collect(item, prefix + k + "/")
                    else:
                        names.append(prefix + k)
            collect(grp)
        out = []
        for n in names:
            node = grp
            for part in n.split("/"):
                if part in node:
                    node = node[part]
            out.append(np.asarray(node))
        return out
