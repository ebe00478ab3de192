from .darknet import Darknet
from .darknet_csp import DarknetCSP
from .detectors_resnet import DetectoRSResNet, DetectoRSResNeXt
from .regnet import RegNet
from .resnet import ResNet, ResNeXt
from .ssd_vgg import SSDVGG

__all__ = ['Darknet', 'DarknetCSP', 'DetectoRSResNet', 'DetectoRSResNeXt',
           'RegNet', 'ResNet', 'ResNeXt', 'SSDVGG']
