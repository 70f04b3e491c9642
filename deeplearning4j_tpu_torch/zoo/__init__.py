"""Zoo models of the PyTorch port, the pretrained catalog and loaders
(`zoo/pretrained.py`) and the ImageNet labels (`zoo/imagenet.py`)."""

from deeplearning4j_tpu_torch.zoo.base import ZOO_REGISTRY, ZooModel
from deeplearning4j_tpu_torch.zoo.models import (
    VGG16, VGG19, AlexNet, LeNet, SimpleCNN, TextGenerationLSTM,
)
from deeplearning4j_tpu_torch.zoo.inception import (
    FaceNetNN4Small2, GoogLeNet, InceptionResNetV1,
)
from deeplearning4j_tpu_torch.zoo.resnet import ResNet50, fold_stem_kernel
from deeplearning4j_tpu_torch.zoo.transformer import TextGenerationTransformer
from deeplearning4j_tpu_torch.zoo.pretrained import (
    PRETRAINED_CATALOG, PretrainedType, fetch_pretrained, load_pretrained,
    sniff_format,
)
from deeplearning4j_tpu_torch.zoo.imagenet import ImageNetLabels

__all__ = ["PRETRAINED_CATALOG", "PretrainedType", "fetch_pretrained",
           "load_pretrained", "sniff_format", "ImageNetLabels",
           "ZOO_REGISTRY", "ZooModel", "AlexNet", "FaceNetNN4Small2",
           "GoogLeNet", "InceptionResNetV1", "LeNet", "ResNet50",
           "SimpleCNN", "TextGenerationLSTM", "TextGenerationTransformer",
           "VGG16", "VGG19", "fold_stem_kernel"]
