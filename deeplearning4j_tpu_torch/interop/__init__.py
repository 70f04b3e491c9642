"""Interop with external checkpoint formats (DL4J zip containers); port
of `deeplearning4j_tpu/interop/`."""

from deeplearning4j_tpu_torch.interop.dl4j import (  # noqa: F401
    export_dl4j_model,
    import_dl4j_model,
    read_nd4j_array,
    write_nd4j_array,
)

__all__ = [
    "export_dl4j_model",
    "import_dl4j_model",
    "read_nd4j_array",
    "write_nd4j_array",
]
