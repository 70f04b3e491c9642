"""Clustering + spatial search + t-SNE (port of
`deeplearning4j_tpu/clustering/`).

Reference parity: deeplearning4j-core `clustering/` (KMeans, VPTree for
k-NN, kdtree/quadtree/sptree) and `plot/BarnesHutTsne.java`.

KMeans' Lloyd iterations and t-SNE run as tensor code on the device
(`device=`, the CUDA device unless the caller asks for the CPU): the
dense O(n²) forms are a few products an iteration, and large n takes
t-SNE's blocked path (see `tsne.py`). BarnesHutTsne keeps the
reference's name and API. VPTree and KDTree stay host structures
(numpy copies of the JAX package's): serving-time k-NN needs
low-latency single queries, not throughput.
"""

from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne

__all__ = ["KMeansClustering", "VPTree", "KDTree", "BarnesHutTsne"]
