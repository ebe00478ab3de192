from .backbones import Darknet, DarknetCSP, RegNet, ResNet, ResNeXt, SSDVGG
from .builder import build_detector
from .dense_heads import (SSD, RetinaHead, RPNHead, SSDHead, YOLOCSPHead,
                          YOLOV3Head)
from .detectors import (RPN, YOLOV3, YOLOV4, YOLOV5, FastRCNN, FasterRCNN,
                        RetinaNet, SingleStageDetector, TwoStageDetector)
from .necks import FPN, YOLOV3Neck, YOLOV4Neck, YOLOV5Neck
from .roi_heads import (CascadeRCNN, CascadeRoIHead, FCNMaskHead, MaskRCNN,
                        MaskRoIHead, Shared2FCBBoxHead, Shared4Conv1FCBBoxHead,
                        StandardRoIHead)

__all__ = ['Darknet', 'DarknetCSP', 'RegNet', 'ResNet', 'ResNeXt', 'SSDVGG',
           'build_detector', 'RetinaHead', 'RPNHead', 'SSDHead', 'SSD',
           'YOLOCSPHead', 'YOLOV3Head', 'YOLOV3',
           'YOLOV4', 'YOLOV5', 'RetinaNet', 'SingleStageDetector', 'RPN',
           'FastRCNN', 'FasterRCNN', 'TwoStageDetector', 'FPN', 'YOLOV3Neck',
           'YOLOV4Neck', 'YOLOV5Neck', 'Shared2FCBBoxHead',
           'Shared4Conv1FCBBoxHead', 'StandardRoIHead', 'CascadeRoIHead',
           'CascadeRCNN', 'FCNMaskHead', 'MaskRoIHead', 'MaskRCNN']
