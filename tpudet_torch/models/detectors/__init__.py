from .rpn import RPN, FastRCNN
from .single_stage import (ATSS, GFL, PAA, YOLOV3, YOLOV4, YOLOV5,
                           RetinaNet, SingleStageDetector, VFNet)
from .two_stage import FasterRCNN, TwoStageDetector

__all__ = ['ATSS', 'GFL', 'PAA', 'VFNet', 'YOLOV3', 'YOLOV4', 'YOLOV5',
           'RetinaNet', 'SingleStageDetector', 'RPN', 'FastRCNN', 'FasterRCNN',
           'TwoStageDetector']
