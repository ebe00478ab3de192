from .bbox_head import Shared2FCBBoxHead
from .mask_head import FCNMaskHead, MaskRCNN, MaskRoIHead
from .standard_roi_head import StandardRoIHead

__all__ = ['Shared2FCBBoxHead', 'StandardRoIHead', 'FCNMaskHead',
           'MaskRoIHead', 'MaskRCNN']
