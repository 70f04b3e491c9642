"""Layers of the PyTorch port; importing this package registers every
ported layer class for config serde."""

from deeplearning4j_tpu_torch.nn.layers.base import LAYER_REGISTRY, Layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    ActivationLayer, AutoEncoder, DenseLayer, DropoutLayer, EmbeddingLayer,
    EmbeddingSequenceLayer, LossLayer, OutputLayer, PReLULayer,
)
from deeplearning4j_tpu_torch.nn.layers.special import (
    RBM, CenterLossOutputLayer, FrozenLayer, VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer, FusedConvBNLayer, SpaceToDepthLayer, SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPoolingLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    GRU, LSTM, BaseRecurrentLayer, Bidirectional, GravesBidirectionalLSTM,
    GravesLSTM, LastTimeStep, RnnOutputLayer, SimpleRnn,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    MultiHeadAttention, PositionEmbeddingLayer, TransformerEncoderBlock,
)

__all__ = [
    "LAYER_REGISTRY", "Layer", "DenseLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer",
    "OutputLayer", "RnnOutputLayer", "BaseRecurrentLayer", "LSTM",
    "GravesLSTM", "GRU", "SimpleRnn", "Bidirectional",
    "GravesBidirectionalLSTM", "LastTimeStep", "MultiHeadAttention",
    "PositionEmbeddingLayer", "TransformerEncoderBlock", "ActivationLayer",
    "DropoutLayer", "ConvolutionLayer", "SubsamplingLayer",
    "ZeroPaddingLayer", "SpaceToDepthLayer", "FusedConvBNLayer",
    "BatchNormalization", "GlobalPoolingLayer", "LossLayer", "PReLULayer",
    "AutoEncoder", "FrozenLayer", "CenterLossOutputLayer",
    "VariationalAutoencoder", "RBM",
]
