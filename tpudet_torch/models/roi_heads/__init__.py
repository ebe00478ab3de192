from .bbox_head import Shared2FCBBoxHead, Shared4Conv1FCBBoxHead
from .cascade_roi_head import CascadeRCNN, CascadeRoIHead
from .mask_head import FCNMaskHead, MaskRCNN, MaskRoIHead
from .standard_roi_head import StandardRoIHead

__all__ = ['Shared2FCBBoxHead', 'Shared4Conv1FCBBoxHead', 'StandardRoIHead',
           'CascadeRoIHead', 'CascadeRCNN', 'FCNMaskHead', 'MaskRoIHead',
           'MaskRCNN']
