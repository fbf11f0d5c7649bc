"""Model zoo: symbol builders (ResNet in this slice)."""
from .resnet import get_resnet, get_resnet50

__all__ = ["get_resnet", "get_resnet50"]
