"""Canned datasets: MNIST, CIFAR-10, Iris (port of
`deeplearning4j_tpu/data/datasets.py`).

Reference parity: deeplearning4j-core `datasets/iterator/impl/`
(MnistDataSetIterator, CifarDataSetIterator, IrisDataSetIterator) and the
binary fetchers in `datasets/mnist/`. Nothing is downloaded: the loaders
read the standard cache layout (`~/.deeplearning4j_tpu/<name>/` or
$DL4J_TPU_DATA_DIR) and otherwise fall back to a DETERMINISTIC synthetic
surrogate with identical shapes and dtypes, flagged via `.synthetic`,
bit-equal to the JAX package's for the same split.

The IDX reader, the byte-to-float scaling and the one-hot encoding are
numpy (the JAX package's fallbacks for its host C++ helpers). Iris ships
embedded (150 rows, public-domain Fisher data). LFW reads its
directory-per-person layout through `data/records.ImageRecordReader`
(PIL, imported only then) or falls back to the synthetic surrogate.
"""

from __future__ import annotations

import gzip
import os
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.iterators import ArrayDataSetIterator


def data_dir() -> str:
    return os.environ.get(
        "DL4J_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu"))


def _synthetic_surrogate(n: int, k: int, shape: Tuple[int, ...],
                         proto_seed: int, sample_seed: int,
                         blend: float = 0.6
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic stand-in when real files are absent: k class
    prototypes blended with per-example noise — separable enough to train
    on, identical shapes/dtypes to the real data."""
    rng = np.random.default_rng(sample_seed)
    protos = np.random.default_rng(proto_seed).random(
        (k,) + shape).astype(np.float32)
    labels = rng.integers(0, k, n)
    x = (blend * protos[labels]
         + (1.0 - blend) * rng.random((n,) + shape, dtype=np.float32))
    return x.astype(np.float32), np.eye(k, dtype=np.float32)[labels]


# ------------------------------------------------------ host byte helpers
_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
               0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}


def read_idx(data: bytes) -> np.ndarray:
    """IDX (MNIST ubyte/int/float) container → ndarray: a 4-byte magic
    (0, 0, dtype code, rank), big-endian int32 dims, big-endian data."""
    if len(data) < 4 or data[0] or data[1]:
        raise ValueError("bad idx header")
    np_dt = _IDX_DTYPES[data[2]]
    nd = data[3]
    shape = tuple(int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big")
                  for i in range(nd))
    arr = np.frombuffer(data, dtype=np.dtype(np_dt).newbyteorder(">"),
                        offset=4 + 4 * nd)
    return arr.reshape(shape).astype(np_dt)


def u8_to_f32(pixels: np.ndarray, scale: float = 1.0 / 255.0) -> np.ndarray:
    """uint8 image bytes → scaled float32."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    return pixels.astype(np.float32) * np.float32(scale)


def one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Integer labels → float32 one-hot rows; out-of-range labels give a
    zero row."""
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    out = np.zeros((labels.size, num_classes), dtype=np.float32)
    ok = (labels >= 0) & (labels < num_classes)
    out[np.arange(labels.size)[ok], labels[ok]] = 1.0
    return out


# --------------------------------------------------------------------- MNIST
def _read_idx_file(path: str, rank: int) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        arr = read_idx(f.read())
    if arr.ndim != rank:
        raise ValueError(f"{path}: idx rank {arr.ndim}, want {rank}")
    return arr


def _find(name_options, base) -> Optional[str]:
    for n in name_options:
        for ext in ("", ".gz"):
            p = os.path.join(base, n + ext)
            if os.path.exists(p):
                return p
    return None


def load_mnist(train: bool = True) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (images [N,784] float32 in [0,1], labels one-hot [N,10],
    synthetic_flag)."""
    base = os.path.join(data_dir(), "mnist")
    prefix = "train" if train else "t10k"
    img = _find([f"{prefix}-images-idx3-ubyte",
                 f"{prefix}-images.idx3-ubyte"], base)
    lab = _find([f"{prefix}-labels-idx1-ubyte",
                 f"{prefix}-labels.idx1-ubyte"], base)
    if img and lab:
        x = u8_to_f32(_read_idx_file(img, 3)).reshape(-1, 784)
        y = one_hot(_read_idx_file(lab, 1), 10)
        return x, y, False
    x, y = _synthetic_surrogate(60000 if train else 10000, 10, (784,),
                                proto_seed=7,
                                sample_seed=42 if train else 43)
    return x, y, True


class MnistDataSetIterator(ArrayDataSetIterator):
    """Reference: `datasets/iterator/impl/MnistDataSetIterator`."""

    def __init__(self, batch_size: int, train: bool = True,
                 shuffle: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None):
        x, y, synthetic = load_mnist(train)
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        self.synthetic = synthetic
        super().__init__(x, y, batch_size, shuffle=shuffle, seed=seed)


# -------------------------------------------------------------------- CIFAR
def load_cifar10(train: bool = True) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (images [N,32,32,3] float32, one-hot labels [N,10],
    synthetic)."""
    base = os.path.join(data_dir(), "cifar-10-batches-bin")
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    paths = [os.path.join(base, f) for f in files]
    if all(os.path.exists(p) for p in paths):
        xs, ys = [], []
        for p in paths:
            raw = np.fromfile(p, np.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0])
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        x = np.concatenate(xs).astype(np.float32) / 255.0
        y = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
        return x, y, False
    x, y = _synthetic_surrogate(50000 if train else 10000, 10, (32, 32, 3),
                                proto_seed=8,
                                sample_seed=44 if train else 45)
    return x, y, True


class CifarDataSetIterator(ArrayDataSetIterator):
    """Reference: `datasets/iterator/impl/CifarDataSetIterator`."""

    def __init__(self, batch_size: int, train: bool = True,
                 shuffle: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None):
        x, y, synthetic = load_cifar10(train)
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        self.synthetic = synthetic
        super().__init__(x, y, batch_size, shuffle=shuffle, seed=seed)


# --------------------------------------------------------------------- Iris
# Fisher's iris data (public domain): 150 rows of
# sepal_len, sepal_wid, petal_len, petal_wid, class(0..2)
_IRIS = np.array([
    [5.1,3.5,1.4,0.2,0],[4.9,3.0,1.4,0.2,0],[4.7,3.2,1.3,0.2,0],[4.6,3.1,1.5,0.2,0],
    [5.0,3.6,1.4,0.2,0],[5.4,3.9,1.7,0.4,0],[4.6,3.4,1.4,0.3,0],[5.0,3.4,1.5,0.2,0],
    [4.4,2.9,1.4,0.2,0],[4.9,3.1,1.5,0.1,0],[5.4,3.7,1.5,0.2,0],[4.8,3.4,1.6,0.2,0],
    [4.8,3.0,1.4,0.1,0],[4.3,3.0,1.1,0.1,0],[5.8,4.0,1.2,0.2,0],[5.7,4.4,1.5,0.4,0],
    [5.4,3.9,1.3,0.4,0],[5.1,3.5,1.4,0.3,0],[5.7,3.8,1.7,0.3,0],[5.1,3.8,1.5,0.3,0],
    [5.4,3.4,1.7,0.2,0],[5.1,3.7,1.5,0.4,0],[4.6,3.6,1.0,0.2,0],[5.1,3.3,1.7,0.5,0],
    [4.8,3.4,1.9,0.2,0],[5.0,3.0,1.6,0.2,0],[5.0,3.4,1.6,0.4,0],[5.2,3.5,1.5,0.2,0],
    [5.2,3.4,1.4,0.2,0],[4.7,3.2,1.6,0.2,0],[4.8,3.1,1.6,0.2,0],[5.4,3.4,1.5,0.4,0],
    [5.2,4.1,1.5,0.1,0],[5.5,4.2,1.4,0.2,0],[4.9,3.1,1.5,0.2,0],[5.0,3.2,1.2,0.2,0],
    [5.5,3.5,1.3,0.2,0],[4.9,3.6,1.4,0.1,0],[4.4,3.0,1.3,0.2,0],[5.1,3.4,1.5,0.2,0],
    [5.0,3.5,1.3,0.3,0],[4.5,2.3,1.3,0.3,0],[4.4,3.2,1.3,0.2,0],[5.0,3.5,1.6,0.6,0],
    [5.1,3.8,1.9,0.4,0],[4.8,3.0,1.4,0.3,0],[5.1,3.8,1.6,0.2,0],[4.6,3.2,1.4,0.2,0],
    [5.3,3.7,1.5,0.2,0],[5.0,3.3,1.4,0.2,0],
    [7.0,3.2,4.7,1.4,1],[6.4,3.2,4.5,1.5,1],[6.9,3.1,4.9,1.5,1],[5.5,2.3,4.0,1.3,1],
    [6.5,2.8,4.6,1.5,1],[5.7,2.8,4.5,1.3,1],[6.3,3.3,4.7,1.6,1],[4.9,2.4,3.3,1.0,1],
    [6.6,2.9,4.6,1.3,1],[5.2,2.7,3.9,1.4,1],[5.0,2.0,3.5,1.0,1],[5.9,3.0,4.2,1.5,1],
    [6.0,2.2,4.0,1.0,1],[6.1,2.9,4.7,1.4,1],[5.6,2.9,3.6,1.3,1],[6.7,3.1,4.4,1.4,1],
    [5.6,3.0,4.5,1.5,1],[5.8,2.7,4.1,1.0,1],[6.2,2.2,4.5,1.5,1],[5.6,2.5,3.9,1.1,1],
    [5.9,3.2,4.8,1.8,1],[6.1,2.8,4.0,1.3,1],[6.3,2.5,4.9,1.5,1],[6.1,2.8,4.7,1.2,1],
    [6.4,2.9,4.3,1.3,1],[6.6,3.0,4.4,1.4,1],[6.8,2.8,4.8,1.4,1],[6.7,3.0,5.0,1.7,1],
    [6.0,2.9,4.5,1.5,1],[5.7,2.6,3.5,1.0,1],[5.5,2.4,3.8,1.1,1],[5.5,2.4,3.7,1.0,1],
    [5.8,2.7,3.9,1.2,1],[6.0,2.7,5.1,1.6,1],[5.4,3.0,4.5,1.5,1],[6.0,3.4,4.5,1.6,1],
    [6.7,3.1,4.7,1.5,1],[6.3,2.3,4.4,1.3,1],[5.6,3.0,4.1,1.3,1],[5.5,2.5,4.0,1.3,1],
    [5.5,2.6,4.4,1.2,1],[6.1,3.0,4.6,1.4,1],[5.8,2.6,4.0,1.2,1],[5.0,2.3,3.3,1.0,1],
    [5.6,2.7,4.2,1.3,1],[5.7,3.0,4.2,1.2,1],[5.7,2.9,4.2,1.3,1],[6.2,2.9,4.3,1.3,1],
    [5.1,2.5,3.0,1.1,1],[5.7,2.8,4.1,1.3,1],
    [6.3,3.3,6.0,2.5,2],[5.8,2.7,5.1,1.9,2],[7.1,3.0,5.9,2.1,2],[6.3,2.9,5.6,1.8,2],
    [6.5,3.0,5.8,2.2,2],[7.6,3.0,6.6,2.1,2],[4.9,2.5,4.5,1.7,2],[7.3,2.9,6.3,1.8,2],
    [6.7,2.5,5.8,1.8,2],[7.2,3.6,6.1,2.5,2],[6.5,3.2,5.1,2.0,2],[6.4,2.7,5.3,1.9,2],
    [6.8,3.0,5.5,2.1,2],[5.7,2.5,5.0,2.0,2],[5.8,2.8,5.1,2.4,2],[6.4,3.2,5.3,2.3,2],
    [6.5,3.0,5.5,1.8,2],[7.7,3.8,6.7,2.2,2],[7.7,2.6,6.9,2.3,2],[6.0,2.2,5.0,1.5,2],
    [6.9,3.2,5.7,2.3,2],[5.6,2.8,4.9,2.0,2],[7.7,2.8,6.7,2.0,2],[6.3,2.7,4.9,1.8,2],
    [6.7,3.3,5.7,2.1,2],[7.2,3.2,6.0,1.8,2],[6.2,2.8,4.8,1.8,2],[6.1,3.0,4.9,1.8,2],
    [6.4,2.8,5.6,2.1,2],[7.2,3.0,5.8,1.6,2],[7.4,2.8,6.1,1.9,2],[7.9,3.8,6.4,2.0,2],
    [6.4,2.8,5.6,2.2,2],[6.3,2.8,5.1,1.5,2],[6.1,2.6,5.6,1.4,2],[7.7,3.0,6.1,2.3,2],
    [6.3,3.4,5.6,2.4,2],[6.4,3.1,5.5,1.8,2],[6.0,3.0,4.8,1.8,2],[6.9,3.1,5.4,2.1,2],
    [6.7,3.1,5.6,2.4,2],[6.9,3.1,5.1,2.3,2],[5.8,2.7,5.1,1.9,2],[6.8,3.2,5.9,2.3,2],
    [6.7,3.3,5.7,2.5,2],[6.7,3.0,5.2,2.3,2],[6.3,2.5,5.0,1.9,2],[6.5,3.0,5.2,2.0,2],
    [6.2,3.4,5.4,2.3,2],[5.9,3.0,5.1,1.8,2],
], dtype=np.float32)


def load_iris() -> Tuple[np.ndarray, np.ndarray]:
    x = _IRIS[:, :4].copy()
    y = np.eye(3, dtype=np.float32)[_IRIS[:, 4].astype(int)]
    return x, y


class IrisDataSetIterator(ArrayDataSetIterator):
    """Reference: `datasets/iterator/impl/IrisDataSetIterator`."""

    def __init__(self, batch_size: int = 150, shuffle: bool = False,
                 seed: int = 123):
        x, y = load_iris()
        super().__init__(x, y, batch_size, shuffle=shuffle, seed=seed)


# ---------------------------------------------------------------------- LFW
def load_lfw(*, height: int = 64, width: int = 64, channels: int = 3,
             num_labels: Optional[int] = None,
             num_examples: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, list, bool]:
    """Labeled Faces in the Wild: (images [N, H, W, C] float32 in [0, 1],
    one-hot labels [N, num_labels], label names, synthetic flag).

    Reads `<data_dir>/lfw/<person>/<image>` through `ImageRecordReader`;
    absent or empty, falls back to the deterministic synthetic surrogate
    (per-identity prototypes blended at 0.7), flagged by the returned
    bool, bit-equal to the JAX package's. `num_labels` keeps the people
    with the most images; `num_examples` truncates after a seeded
    shuffle."""
    base = os.path.join(data_dir(), "lfw")
    per_label: dict = {}
    if os.path.isdir(base):
        from deeplearning4j_tpu_torch.data.records import ImageRecordReader

        rr = ImageRecordReader(base, height=height, width=width,
                               channels=channels)
        for arr, li in rr:
            per_label.setdefault(li, []).append(arr)
    if per_label:
        keep = sorted(per_label, key=lambda li: (-len(per_label[li]), li))
        if num_labels:
            keep = keep[:num_labels]
        names = [rr.labels[li] for li in keep]
        xs, ys = [], []
        for new_li, li in enumerate(keep):
            xs.extend(per_label[li])
            ys.extend([new_li] * len(per_label[li]))
        x = np.asarray(xs, np.float32)
        y = np.eye(len(keep), dtype=np.float32)[np.asarray(ys)]
        if num_examples:
            # examples are grouped by identity: shuffle before cutting
            sel = np.random.default_rng(12345).permutation(len(x))[
                :num_examples]
            x, y = x[sel], y[sel]
        return x, y, names, False
    k = num_labels or 10
    n = num_examples or 40 * k
    x, y = _synthetic_surrogate(n, k, (height, width, channels),
                                proto_seed=9, sample_seed=46, blend=0.7)
    return x, y, [f"person_{i:04d}" for i in range(k)], True


class LFWDataSetIterator(ArrayDataSetIterator):
    """Reference: `datasets/iterator/impl/LFWDataSetIterator.java`: the
    batch size, image shape, example and label counts, and a seeded
    train/test split (`split_train_test` of the examples train)."""

    def __init__(self, batch_size: int,
                 image_shape: Tuple[int, int, int] = (64, 64, 3), *,
                 train: bool = True, split_train_test: float = 0.8,
                 num_examples: Optional[int] = None,
                 num_labels: Optional[int] = None, shuffle: bool = True,
                 seed: int = 123):
        h, w, c = image_shape
        x, y, names, synthetic = load_lfw(
            height=h, width=w, channels=c, num_labels=num_labels,
            num_examples=num_examples)
        perm = np.random.default_rng(seed).permutation(len(x))
        cut = int(len(x) * split_train_test)
        sel = perm[:cut] if train else perm[cut:]
        self.synthetic = synthetic
        self.label_names = names
        super().__init__(x[sel], y[sel], batch_size, shuffle=shuffle,
                         seed=seed)
