from .darknet import Darknet
from .darknet_csp import DarknetCSP
from .resnet import ResNet, ResNeXt

__all__ = ['Darknet', 'DarknetCSP', 'ResNet', 'ResNeXt']
