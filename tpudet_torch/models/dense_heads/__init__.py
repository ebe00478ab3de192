from .atss_head import ATSSHead
from .gfl_head import GFLHead
from .ld_head import KnowledgeDistillationSingleStageDetector, LDHead
from .retina_head import RetinaHead
from .rpn_head import RPNHead
from .ssd_head import SSD, SSDHead
from .vfnet_head import VFNetHead
from .yolocsp_head import YOLOCSPHead
from .yolov3_head import YOLOV3Head

__all__ = ['ATSSHead', 'GFLHead', 'KnowledgeDistillationSingleStageDetector',
           'LDHead', 'RetinaHead', 'RPNHead', 'SSD', 'SSDHead', 'VFNetHead',
           'YOLOCSPHead', 'YOLOV3Head']
