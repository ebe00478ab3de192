from .mean_ap import (FlexibleStatisticsEval, NoBreakdown, ScaleBreakdown,
                      average_precision, coco_fast_bbox_eval,
                      coco_fast_segm_eval,
                      eval_map_flexible, iou_coco, match_best_only,
                      match_coco)

__all__ = [
    'average_precision', 'iou_coco', 'match_coco', 'match_best_only',
    'eval_map_flexible', 'FlexibleStatisticsEval', 'NoBreakdown',
    'ScaleBreakdown', 'coco_fast_bbox_eval', 'coco_fast_segm_eval'
]
