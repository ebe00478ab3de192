from .atss_head import ATSSHead
from .autoassign_head import AutoAssign, AutoAssignHead
from .cascade_rpn_head import CascadeRPNHead, StageCascadeRPN
from .fcos_head import FCOSHead
from .fovea_head import FoveaHead
from .free_anchor_retina_head import FreeAnchorRetinaHead
from .fsaf_head import FSAFHead
from .gfl_head import GFLHead
from .guided_anchor_head import FeatureAdaption, GARetinaHead, GARPNHead
from .ld_head import KnowledgeDistillationSingleStageDetector, LDHead
from .nasfcos_head import NASFCOS, NASFCOSHead
from .paa_head import PAAHead
from .reppoints_head import RepPointsHead
from .retina_head import RetinaHead
from .retina_sepbn_head import RetinaSepBNHead
from .rpn_head import RPNHead
from .sabl_retina_head import SABLRetinaHead
from .ssd_head import SSD, SSDHead
from .vfnet_head import VFNetHead
from .yolocsp_head import YOLOCSPHead
from .yolact_head import (YOLACT, YOLACTHead, YOLACTProtonet,
                          YOLACTSegmHead)
from .yolof_head import YOLOFHead
from .yolov3_head import YOLOV3Head

__all__ = ['ATSSHead', 'AutoAssign', 'AutoAssignHead', 'CascadeRPNHead',
           'StageCascadeRPN', 'FCOSHead',
           'FoveaHead', 'FreeAnchorRetinaHead', 'FSAFHead', 'NASFCOS',
           'NASFCOSHead', 'RetinaSepBNHead', 'YOLOFHead', 'GFLHead',
           'FeatureAdaption', 'GARetinaHead', 'GARPNHead', 'RepPointsHead',
           'SABLRetinaHead',
           'KnowledgeDistillationSingleStageDetector', 'LDHead', 'PAAHead',
           'RetinaHead', 'RPNHead', 'SSD', 'SSDHead',
           'VFNetHead', 'YOLACT', 'YOLACTHead', 'YOLACTProtonet',
           'YOLACTSegmHead', 'YOLOCSPHead', 'YOLOV3Head']
