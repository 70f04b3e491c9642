"""Zoo models of the PyTorch port."""

from deeplearning4j_tpu_torch.zoo.base import ZOO_REGISTRY, ZooModel
from deeplearning4j_tpu_torch.zoo.models import (
    VGG16, VGG19, AlexNet, LeNet, SimpleCNN, TextGenerationLSTM,
)
from deeplearning4j_tpu_torch.zoo.resnet import ResNet50, fold_stem_kernel
from deeplearning4j_tpu_torch.zoo.transformer import TextGenerationTransformer

__all__ = ["ZOO_REGISTRY", "ZooModel", "AlexNet", "LeNet", "ResNet50",
           "SimpleCNN", "TextGenerationLSTM", "TextGenerationTransformer",
           "VGG16", "VGG19", "fold_stem_kernel"]
