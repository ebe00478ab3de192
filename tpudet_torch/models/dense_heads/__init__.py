from .retina_head import RetinaHead
from .yolocsp_head import YOLOCSPHead

__all__ = ['RetinaHead', 'YOLOCSPHead']
