from .yolo_neck_csp import YOLOV4Neck

__all__ = ['YOLOV4Neck']
