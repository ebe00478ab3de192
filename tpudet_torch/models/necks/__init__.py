from .bfp import BFP
from .fpn import FPN
from .rfp import RFP
from .yolo_neck import YOLOV3Neck
from .yolo_neck_csp import YOLOV4Neck, YOLOV5Neck

__all__ = ['BFP', 'FPN', 'RFP', 'YOLOV3Neck', 'YOLOV4Neck', 'YOLOV5Neck']
