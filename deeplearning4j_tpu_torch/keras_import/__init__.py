"""Keras .h5 and JSON model import (port of
`deeplearning4j_tpu/keras_import/`).

Reference parity: deeplearning4j-modelimport (`KerasModelImport.java:48-192`,
`KerasModel.java`, `KerasLayer.java`, `Hdf5Archive.java`) — parse the Keras
JSON config stored in the HDF5 file, map layers to native configs
(Sequential → MultiLayerNetwork, functional Model → ComputationGraph), and
copy weights with convention transposes. h5py reads the file, imported
only when one is opened; a configuration given as JSON or YAML text needs
no h5py, and its weights can be set from numpy afterwards.
"""

from deeplearning4j_tpu_torch.keras_import.h5 import Hdf5Archive
from deeplearning4j_tpu_torch.keras_import.importer import (
    KerasModelImport, import_keras_configuration,
    import_keras_model_and_weights,
)

__all__ = ["KerasModelImport", "import_keras_configuration",
           "import_keras_model_and_weights", "Hdf5Archive"]
