from .darknet_csp import DarknetCSP
from .resnet import ResNet, ResNeXt

__all__ = ['DarknetCSP', 'ResNet', 'ResNeXt']
