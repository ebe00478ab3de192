from .backbones import DarknetCSP, ResNet, ResNeXt
from .builder import build_detector
from .dense_heads import RetinaHead, YOLOCSPHead
from .detectors import YOLOV4, YOLOV5, RetinaNet, SingleStageDetector
from .necks import FPN, YOLOV4Neck, YOLOV5Neck

__all__ = ['DarknetCSP', 'ResNet', 'ResNeXt', 'build_detector', 'RetinaHead',
           'YOLOCSPHead', 'YOLOV4', 'YOLOV5', 'RetinaNet',
           'SingleStageDetector', 'FPN', 'YOLOV4Neck', 'YOLOV5Neck']
