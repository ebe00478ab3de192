from .backbones import DarknetCSP
from .builder import build_detector
from .dense_heads import YOLOCSPHead
from .detectors import YOLOV4, YOLOV5, SingleStageDetector
from .necks import YOLOV4Neck, YOLOV5Neck

__all__ = ['DarknetCSP', 'build_detector', 'YOLOCSPHead', 'YOLOV4', 'YOLOV5',
           'SingleStageDetector', 'YOLOV4Neck', 'YOLOV5Neck']
