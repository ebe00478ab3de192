from .bbox_head import Shared2FCBBoxHead
from .standard_roi_head import StandardRoIHead

__all__ = ['Shared2FCBBoxHead', 'StandardRoIHead']
