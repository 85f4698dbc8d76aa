"""Keras model import (counterpart of deeplearning4j_tpu/modelimport/),
reading HDF5 through the port's own reader (modelimport/hdf5.py)."""

from deeplearning4j_tpu_torch.modelimport.keras import (  # noqa: F401
    KerasImportError,
    KerasModelImport,
    register_custom_layer,
    unregister_custom_layer,
)
