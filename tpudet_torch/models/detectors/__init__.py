from .rpn import RPN, FastRCNN
from .single_stage import (ATSS, FCOS, FOVEA, FSAF, GFL, PAA, YOLOF,
                           YOLOV3, YOLOV4, YOLOV5, GARetinaNet,
                           RepPointsDetector, RetinaNet, SABLRetinaNet,
                           SingleStageDetector, VFNet)
from .two_stage import FasterRCNN, TwoStageDetector

__all__ = ['ATSS', 'FCOS', 'FOVEA', 'FSAF', 'GFL', 'PAA', 'VFNet', 'YOLOF',
           'YOLOV3', 'YOLOV4', 'YOLOV5', 'GARetinaNet', 'RepPointsDetector',
           'RetinaNet', 'SABLRetinaNet', 'SingleStageDetector',
           'RPN', 'FastRCNN', 'FasterRCNN', 'TwoStageDetector']
