"""Data containers and iterators of the PyTorch port."""

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator, DataSetIterator, DevicePrefetchIterator,
    as_iterator,
)

__all__ = ["DataSet", "DataSetIterator", "ArrayDataSetIterator",
           "DevicePrefetchIterator", "as_iterator"]
