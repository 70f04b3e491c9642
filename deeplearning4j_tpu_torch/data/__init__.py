"""Data containers, iterators and canned datasets of the PyTorch port."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.datasets import (
    CifarDataSetIterator, IrisDataSetIterator, LFWDataSetIterator,
    MnistDataSetIterator, load_cifar10, load_iris, load_lfw, load_mnist,
)
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator, DataSetIterator, DevicePrefetchIterator,
    as_iterator,
)

__all__ = ["DataSet", "MultiDataSet", "DataSetIterator", "ArrayDataSetIterator",
           "DevicePrefetchIterator", "as_iterator", "load_mnist",
           "MnistDataSetIterator", "load_cifar10", "CifarDataSetIterator",
           "load_iris", "IrisDataSetIterator", "load_lfw",
           "LFWDataSetIterator"]
