"""Model zoo: symbol builders, counterparts of ``mxnet_tpu/models``
(ResNet, the MNIST and Inception-BN networks, and the ImageNet
classifiers AlexNet, VGG, GoogLeNet and Inception-v3)."""
from .mlp import get_mlp
from .lenet import get_lenet
from .resnet import get_resnet, get_resnet50
from .inception_bn import get_inception_bn, get_inception_bn_28_small
from .vision import (get_alexnet, get_vgg, get_googlenet,
                     get_inception_v3)

__all__ = ["get_mlp", "get_lenet", "get_resnet", "get_resnet50",
           "get_inception_bn", "get_inception_bn_28_small", "get_alexnet",
           "get_vgg", "get_googlenet", "get_inception_v3"]
