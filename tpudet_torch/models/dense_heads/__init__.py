from .atss_head import ATSSHead
from .gfl_head import GFLHead
from .ld_head import KnowledgeDistillationSingleStageDetector, LDHead
from .paa_head import PAAHead
from .retina_head import RetinaHead
from .rpn_head import RPNHead
from .ssd_head import SSD, SSDHead
from .vfnet_head import VFNetHead
from .yolocsp_head import YOLOCSPHead
from .yolact_head import (YOLACT, YOLACTHead, YOLACTProtonet,
                          YOLACTSegmHead)
from .yolov3_head import YOLOV3Head

__all__ = ['ATSSHead', 'GFLHead', 'KnowledgeDistillationSingleStageDetector',
           'LDHead', 'PAAHead', 'RetinaHead', 'RPNHead', 'SSD', 'SSDHead',
           'VFNetHead', 'YOLACT', 'YOLACTHead', 'YOLACTProtonet',
           'YOLACTSegmHead', 'YOLOCSPHead', 'YOLOV3Head']
