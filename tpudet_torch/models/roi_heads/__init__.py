from .bbox_head import Shared2FCBBoxHead, Shared4Conv1FCBBoxHead
from .cascade_roi_head import CascadeRCNN, CascadeRoIHead
from .double_roi_head import (DoubleConvFCBBoxHead, DoubleHeadRCNN,
                              DoubleHeadRoIHead)
from .dynamic_roi_head import DynamicRCNN, DynamicRoIHead
from .grid_roi_head import GridHead, GridRCNN, GridRoIHead
from .mask_head import FCNMaskHead, MaskRCNN, MaskRoIHead
from .htc_roi_head import FusedSemanticHead, HTCRoIHead, HybridTaskCascade
from .pisa_roi_head import PISAFasterRCNN, PISARoIHead
from .mask_scoring_roi_head import (MaskIoUHead, MaskScoringRCNN,
                                    MaskScoringRoIHead)
from .point_rend_roi_head import (CoarseMaskHead, MaskPointHead, PointRend,
                                  PointRendRoIHead)
from .sabl_roi_head import SABLBBoxHead, SABLFasterRCNN, SABLRoIHead
from .scnet_roi_head import SCNet, SCNetRoIHead
from .standard_roi_head import StandardRoIHead

__all__ = ['Shared2FCBBoxHead', 'Shared4Conv1FCBBoxHead', 'StandardRoIHead',
           'CascadeRoIHead', 'CascadeRCNN', 'FCNMaskHead', 'MaskRoIHead',
           'MaskRCNN', 'FusedSemanticHead', 'HTCRoIHead', 'HybridTaskCascade',
           'MaskIoUHead', 'MaskScoringRoIHead', 'MaskScoringRCNN',
           'CoarseMaskHead', 'MaskPointHead', 'PointRendRoIHead', 'PointRend',
           'SCNetRoIHead', 'SCNet', 'SABLBBoxHead', 'SABLRoIHead',
           'SABLFasterRCNN', 'DoubleConvFCBBoxHead', 'DoubleHeadRoIHead',
           'DoubleHeadRCNN', 'DynamicRoIHead', 'DynamicRCNN', 'GridHead',
           'GridRoIHead', 'GridRCNN', 'PISARoIHead', 'PISAFasterRCNN']
