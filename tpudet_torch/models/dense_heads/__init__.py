from .retina_head import RetinaHead
from .rpn_head import RPNHead
from .yolocsp_head import YOLOCSPHead

__all__ = ['RetinaHead', 'RPNHead', 'YOLOCSPHead']
