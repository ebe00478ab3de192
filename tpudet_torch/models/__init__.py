from .backbones import Darknet, DarknetCSP, RegNet, ResNet, ResNeXt, SSDVGG
from .builder import build_detector
from .dense_heads import (SSD, ATSSHead, GFLHead,
                          KnowledgeDistillationSingleStageDetector, LDHead,
                          PAAHead, RetinaHead, RPNHead, SSDHead, VFNetHead,
                          YOLOCSPHead, YOLOV3Head)
from .detectors import (ATSS, GFL, PAA, RPN, YOLOV3, YOLOV4, YOLOV5, FastRCNN,
                        FasterRCNN, RetinaNet, SingleStageDetector,
                        TwoStageDetector, VFNet)
from .necks import BFP, FPN, YOLOV3Neck, YOLOV4Neck, YOLOV5Neck
from .roi_heads import (CascadeRCNN, CascadeRoIHead, FCNMaskHead, MaskRCNN,
                        MaskRoIHead, Shared2FCBBoxHead, Shared4Conv1FCBBoxHead,
                        StandardRoIHead)

__all__ = ['Darknet', 'DarknetCSP', 'RegNet', 'ResNet', 'ResNeXt', 'SSDVGG',
           'build_detector', 'ATSSHead', 'GFLHead', 'LDHead', 'PAAHead',
           'VFNetHead', 'PAA', 'BFP',
           'KnowledgeDistillationSingleStageDetector', 'ATSS', 'GFL', 'VFNet',
           'RetinaHead', 'RPNHead', 'SSDHead', 'SSD',
           'YOLOCSPHead', 'YOLOV3Head', 'YOLOV3',
           'YOLOV4', 'YOLOV5', 'RetinaNet', 'SingleStageDetector', 'RPN',
           'FastRCNN', 'FasterRCNN', 'TwoStageDetector', 'FPN', 'YOLOV3Neck',
           'YOLOV4Neck', 'YOLOV5Neck', 'Shared2FCBBoxHead',
           'Shared4Conv1FCBBoxHead', 'StandardRoIHead', 'CascadeRoIHead',
           'CascadeRCNN', 'FCNMaskHead', 'MaskRoIHead', 'MaskRCNN']
