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
    Convolution1DLayer, ConvolutionLayer, Cropping2DLayer,
    Deconvolution2DLayer, DepthwiseConvolution2DLayer, FusedConvBNLayer,
    SeparableConvolution2DLayer, SpaceToDepthLayer, Subsampling1DLayer,
    SubsamplingLayer, Upsampling2DLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization, LayerNormalization, LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.pooling import (
    GlobalPoolingLayer, PoolingType,
)
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
    "Convolution1DLayer", "Subsampling1DLayer", "Upsampling2DLayer",
    "SeparableConvolution2DLayer", "Deconvolution2DLayer",
    "DepthwiseConvolution2DLayer", "Cropping2DLayer",
    "BatchNormalization", "LocalResponseNormalization", "LayerNormalization",
    "GlobalPoolingLayer", "PoolingType", "LossLayer", "PReLULayer",
    "AutoEncoder", "FrozenLayer", "CenterLossOutputLayer",
    "VariationalAutoencoder", "RBM",
]
