from .fpn import FPN
from .yolo_neck_csp import YOLOV4Neck, YOLOV5Neck

__all__ = ['FPN', 'YOLOV4Neck', 'YOLOV5Neck']
