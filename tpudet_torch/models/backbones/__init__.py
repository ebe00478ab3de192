from .darknet import Darknet
from .darknet_csp import DarknetCSP
from .regnet import RegNet
from .resnet import ResNet, ResNeXt
from .ssd_vgg import SSDVGG

__all__ = ['Darknet', 'DarknetCSP', 'RegNet', 'ResNet', 'ResNeXt', 'SSDVGG']
