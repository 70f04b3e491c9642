"""Keras-backend gateway — deeplearning4j-keras parity (port of
`deeplearning4j_tpu/serving/keras_gateway.py`).

Reference parity: `deeplearning4j-keras/` (SURVEY §2.7) — a py4j
`GatewayServer` (`keras/Server.java:18`) through which Python Keras calls
`DeepLearning4jEntryPoint.fit(...)` on a .h5-exported model, plus
`HDF5MiniBatchDataSetIterator` for batch files on disk.

TPU-native redesign: py4j existed to cross the Python↔JVM boundary; here
both sides are Python, so the gateway is a plain HTTP JSON API (shared
plumbing in serving/http_base.py) any Keras user can hit from a notebook:
POST /import (h5 path) → model id, POST /fit, POST /predict, GET /models.
The h5 parsing rides keras_import (SURVEY §2.7 HDF5 ↦ native reader).
Per-model locks serialize concurrent fit/predict on one model (the request
server is threaded; a MultiLayerNetwork is not thread-safe under fit).
Imported models live on the gateway's `device` (CUDA by default).
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from deeplearning4j_tpu_torch.serving.http_base import JsonHttpServer


class KerasGatewayServer(JsonHttpServer):
    """Serve import/fit/predict for Keras-exported models over HTTP."""

    def __init__(self, *, port: int = 0, device=None):
        super().__init__(port=port)
        self.device = device
        self._models: Dict[str, object] = {}
        self._model_locks: Dict[str, threading.Lock] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    # -- entry-point operations (DeepLearning4jEntryPoint parity) -----
    def import_model(self, h5_path: str) -> str:
        from deeplearning4j_tpu_torch.keras_import import (
            import_keras_model_and_weights,
        )

        net = import_keras_model_and_weights(h5_path, device=self.device)
        with self._lock:
            mid = f"model-{self._next_id}"
            self._next_id += 1
            self._models[mid] = net
            self._model_locks[mid] = threading.Lock()
        return mid

    def fit(self, model_id: str, x, y, *, epochs: int = 1,
            batch_size: int = 32) -> float:
        with self._lock:
            net = self._models[model_id]
            model_lock = self._model_locks[model_id]
        with model_lock:
            net.fit(np.asarray(x, np.float32), np.asarray(y, np.float32),
                    epochs=epochs, batch_size=batch_size)
            return float(net.score_)

    def predict(self, model_id: str, x):
        with self._lock:
            net = self._models[model_id]
            model_lock = self._model_locks[model_id]
        with model_lock:
            out = net.output(np.asarray(x, np.float32))
        if isinstance(out, dict):
            out = next(iter(out.values()))
        if isinstance(out, (list, tuple)):
            out = out[0]
        return out.detach().float().cpu().numpy()

    # -- routes --------------------------------------------------------
    def get_routes(self):
        routes = super().get_routes()
        routes["/models"] = lambda: {"models": sorted(self._models)}
        return routes

    def post_routes(self):
        return {
            "/import": lambda req: {
                "model_id": self.import_model(req["path"])},
            "/fit": lambda req: {"score": self.fit(
                req["model_id"], req["features"], req["labels"],
                epochs=int(req.get("epochs", 1)),
                batch_size=int(req.get("batch_size", 32)))},
            "/predict": lambda req: {"output": self.predict(
                req["model_id"], req["features"]).tolist()},
        }
