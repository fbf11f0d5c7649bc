"""Model zoo: symbol builders, counterparts of ``mxnet_tpu/models``
(ResNet, and the MNIST and Inception-BN networks)."""
from .mlp import get_mlp
from .lenet import get_lenet
from .resnet import get_resnet, get_resnet50
from .inception_bn import get_inception_bn, get_inception_bn_28_small

__all__ = ["get_mlp", "get_lenet", "get_resnet", "get_resnet50",
           "get_inception_bn", "get_inception_bn_28_small"]
