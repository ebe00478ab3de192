from .single_stage import YOLOV4, SingleStageDetector

__all__ = ['YOLOV4', 'SingleStageDetector']
