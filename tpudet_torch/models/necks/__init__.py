from .fpn import FPN
from .yolo_neck import YOLOV3Neck
from .yolo_neck_csp import YOLOV4Neck, YOLOV5Neck

__all__ = ['FPN', 'YOLOV3Neck', 'YOLOV4Neck', 'YOLOV5Neck']
