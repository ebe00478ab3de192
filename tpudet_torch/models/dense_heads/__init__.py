from .retina_head import RetinaHead
from .rpn_head import RPNHead
from .ssd_head import SSD, SSDHead
from .yolocsp_head import YOLOCSPHead
from .yolov3_head import YOLOV3Head

__all__ = ['RetinaHead', 'RPNHead', 'SSD', 'SSDHead', 'YOLOCSPHead',
           'YOLOV3Head']
