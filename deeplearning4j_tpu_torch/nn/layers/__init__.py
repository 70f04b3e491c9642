"""Layers of the PyTorch port; importing this package registers every
ported layer class for config serde."""

from deeplearning4j_tpu_torch.nn.layers.base import LAYER_REGISTRY, Layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    DenseLayer, EmbeddingLayer, EmbeddingSequenceLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.layers.attention import (
    MultiHeadAttention, PositionEmbeddingLayer, TransformerEncoderBlock,
)

__all__ = [
    "LAYER_REGISTRY", "Layer", "DenseLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer",
    "OutputLayer", "RnnOutputLayer", "MultiHeadAttention",
    "PositionEmbeddingLayer", "TransformerEncoderBlock",
]
