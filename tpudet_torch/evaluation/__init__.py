from .mean_ap import (FlexibleStatisticsEval, NoBreakdown, ScaleBreakdown,
                      average_precision, coco_fast_bbox_eval,
                      coco_fast_segm_eval,
                      eval_map_flexible, iou_coco, match_best_only,
                      match_coco)
from .recall import coco_proposal_fast_eval, eval_recalls
from .voc_map import eval_map

__all__ = [
    'average_precision', 'iou_coco', 'match_coco', 'match_best_only',
    'eval_map_flexible', 'FlexibleStatisticsEval', 'NoBreakdown',
    'ScaleBreakdown', 'coco_fast_bbox_eval', 'coco_fast_segm_eval',
    'eval_recalls', 'coco_proposal_fast_eval', 'eval_map'
]
