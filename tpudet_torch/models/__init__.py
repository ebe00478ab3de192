from .backbones import DarknetCSP, ResNet, ResNeXt
from .builder import build_detector
from .dense_heads import RetinaHead, RPNHead, YOLOCSPHead
from .detectors import (RPN, YOLOV4, YOLOV5, FastRCNN, FasterRCNN, RetinaNet,
                        SingleStageDetector, TwoStageDetector)
from .necks import FPN, YOLOV4Neck, YOLOV5Neck
from .roi_heads import (FCNMaskHead, MaskRCNN, MaskRoIHead, Shared2FCBBoxHead,
                        StandardRoIHead)

__all__ = ['DarknetCSP', 'ResNet', 'ResNeXt', 'build_detector', 'RetinaHead',
           'RPNHead', 'YOLOCSPHead', 'YOLOV4', 'YOLOV5', 'RetinaNet',
           'SingleStageDetector', 'RPN', 'FastRCNN', 'FasterRCNN',
           'TwoStageDetector', 'FPN', 'YOLOV4Neck', 'YOLOV5Neck',
           'Shared2FCBBoxHead', 'StandardRoIHead', 'FCNMaskHead',
           'MaskRoIHead', 'MaskRCNN']
