from .yolo_neck_csp import YOLOV4Neck, YOLOV5Neck

__all__ = ['YOLOV4Neck', 'YOLOV5Neck']
