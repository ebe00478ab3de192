from .rpn import RPN, FastRCNN
from .single_stage import (ATSS, GFL, YOLOV3, YOLOV4, YOLOV5, RetinaNet,
                           SingleStageDetector, VFNet)
from .two_stage import FasterRCNN, TwoStageDetector

__all__ = ['ATSS', 'GFL', 'VFNet', 'YOLOV3', 'YOLOV4', 'YOLOV5', 'RetinaNet',
           'SingleStageDetector', 'RPN', 'FastRCNN', 'FasterRCNN',
           'TwoStageDetector']
