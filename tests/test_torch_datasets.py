"""The port's canned datasets against the JAX package's, on the CPU: the
synthetic MNIST, CIFAR-10 and Iris data (the surrogates when no files
are present, and Iris's embedded rows) bit-equal; an IDX pair and a
CIFAR `.bin` written under a temporary `DL4J_TPU_DATA_DIR` load
bit-equal through both packages' loaders; `MnistDataSetIterator` gives
JAX's batches for the same seed; LFW's surrogate (once refused, A1b). Exact equality
throughout: the same numpy arithmetic on the same bytes."""

import gzip

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.data import datasets as jds
from deeplearning4j_tpu_torch.data import datasets as pds


@pytest.fixture
def no_data(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "empty"))


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("loader", ["load_mnist", "load_cifar10"])
def test_surrogates_are_bit_equal(no_data, loader, train):
    px, py, psyn = getattr(pds, loader)(train)
    jx, jy, jsyn = getattr(jds, loader)(train)
    assert psyn and jsyn
    _equal(px, jx)
    _equal(py, jy)


def test_iris_rows_are_bit_equal():
    (px, py), (jx, jy) = pds.load_iris(), jds.load_iris()
    _equal(px, jx)
    _equal(py, jy)
    assert px.shape == (150, 4) and py.sum(0).tolist() == [50, 50, 50]
    pb = next(iter(pds.IrisDataSetIterator(batch_size=40)))
    jb = next(iter(jds.IrisDataSetIterator(batch_size=40)))
    _equal(pb.features, jb.features)


def _idx(arr: np.ndarray, code: int) -> bytes:
    head = bytes([0, 0, code, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape)
    return head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gzip"])
def test_mnist_idx_files_load_bit_equal(tmp_path, monkeypatch, gz):
    rng = np.random.default_rng(0)
    base = tmp_path / "mnist"
    base.mkdir()
    imgs = rng.integers(0, 256, (7, 28, 28), dtype=np.uint8)
    labs = rng.integers(0, 10, 7).astype(np.uint8)
    for name, arr in (("t10k-images-idx3-ubyte", imgs),
                      ("t10k-labels-idx1-ubyte", labs)):
        data = _idx(arr, 0x08)
        if gz:
            (base / (name + ".gz")).write_bytes(gzip.compress(data))
        else:
            (base / name).write_bytes(data)
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    px, py, psyn = pds.load_mnist(train=False)
    jx, jy, jsyn = jds.load_mnist(train=False)
    assert not psyn and not jsyn
    _equal(px, jx)
    _equal(py, jy)
    np.testing.assert_array_equal(py.argmax(1), labs)


@pytest.mark.parametrize("code,dtype", [(0x08, np.uint8), (0x0B, np.int16),
                                        (0x0D, np.float32)])
def test_read_idx_dtypes(code, dtype):
    arr = np.arange(24).reshape(2, 3, 4).astype(dtype)
    _equal(pds.read_idx(_idx(arr, code)), arr)
    _equal(pds.read_idx(_idx(arr, code)), jnative.read_idx(_idx(arr, code)))
    with pytest.raises(ValueError, match="bad idx header"):
        pds.read_idx(b"\x01\x00\x08\x01")


def test_cifar_bin_loads_bit_equal(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    base = tmp_path / "cifar-10-batches-bin"
    base.mkdir()
    rows = rng.integers(0, 256, (5, 3073), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 10, 5)
    rows.tofile(base / "test_batch.bin")
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    px, py, psyn = pds.load_cifar10(train=False)
    jx, jy, jsyn = jds.load_cifar10(train=False)
    assert not psyn and not jsyn
    _equal(px, jx)
    _equal(py, jy)
    assert px.shape == (5, 32, 32, 3)


def test_mnist_iterator_batches_match_jax(no_data):
    kw = dict(batch_size=64, num_examples=200, seed=9)
    pit, jit = pds.MnistDataSetIterator(**kw), jds.MnistDataSetIterator(**kw)
    assert pit.synthetic and jit.synthetic
    for _ in range(2):                       # two epochs: two shuffles
        pb, jb = list(pit), list(jit)
        assert [b.num_examples() for b in pb] == [64, 64, 64, 8]
        for p, j in zip(pb, jb):
            _equal(p.features, j.features)
            _equal(p.labels, j.labels)


def test_lfw_refuses_naming_a1b(no_data):
    """Once refused naming A1b: with no `lfw/` directory the loader and
    iterator give JAX's synthetic surrogate, bit for bit."""
    kw = dict(height=16, width=12, channels=3, num_labels=4,
              num_examples=30)
    got, want = pds.load_lfw(**kw), jds.load_lfw(**kw)
    assert got[3] and want[3] and got[2] == want[2]
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    pit = pds.LFWDataSetIterator(8, (16, 12, 3), num_examples=30, seed=3)
    jit = jds.LFWDataSetIterator(8, (16, 12, 3), num_examples=30, seed=3)
    assert pit.synthetic and pit.label_names == jit.label_names
    for p, j in zip(pit, jit):
        _equal(p.features, j.features)
        _equal(p.labels, j.labels)
