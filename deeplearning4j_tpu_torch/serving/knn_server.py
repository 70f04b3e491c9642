"""REST k-nearest-neighbors server over a VPTree (port of
`deeplearning4j_tpu/serving/knn_server.py`).

Reference parity: `nearestneighbor/server/NearestNeighborsServer.java:37`
(Play REST → shared stdlib plumbing in serving/http_base.py):
  POST /knn        {"ndarray": [...], "k": 5}        → neighbors of a vector
  POST /knnindex   {"index": 3, "k": 5}              → neighbors of a row
  GET  /healthz
Responses: {"results": [{"index": i, "distance": d}, ...]}

The tree is the port's numpy copy of the JAX package's `VPTree` (float64
distances on the host), so both servers answer the same requests with
the same neighbours and distances.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.serving.http_base import JsonHttpServer


class NearestNeighborsServer(JsonHttpServer):
    def __init__(self, points: np.ndarray, *, port: int = 9000,
                 metric: str = "euclidean"):
        super().__init__(port=port)
        self.points = np.asarray(points)
        self.tree = VPTree(self.points, metric=metric)

    @staticmethod
    def _results(idx, dist):
        return {"results": [{"index": int(i), "distance": float(d)}
                            for i, d in zip(idx, dist)]}

    def _knn(self, req: dict):
        vec = np.asarray(req["ndarray"], np.float64)
        idx, dist = self.tree.search(vec, int(req.get("k", 5)))
        return self._results(idx, dist)

    def _knn_index(self, req: dict):
        i = int(req["index"])
        k = int(req.get("k", 5))
        idx, dist = self.tree.search(self.points[i], k + 1)
        pairs = [(j, d) for j, d in zip(idx, dist) if j != i][:k]
        return self._results([j for j, _ in pairs], [d for _, d in pairs])

    def get_routes(self):
        return {"/healthz":
                lambda: {"status": "ok", "points": len(self.points)}}

    def post_routes(self):
        return {"/knn": self._knn, "/knnindex": self._knn_index}
