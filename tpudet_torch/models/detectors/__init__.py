from .rpn import RPN, FastRCNN
from .single_stage import (YOLOV3, YOLOV4, YOLOV5, RetinaNet,
                           SingleStageDetector)
from .two_stage import FasterRCNN, TwoStageDetector

__all__ = ['YOLOV3', 'YOLOV4', 'YOLOV5', 'RetinaNet', 'SingleStageDetector',
           'RPN', 'FastRCNN', 'FasterRCNN', 'TwoStageDetector']
