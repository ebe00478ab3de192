from .single_stage import YOLOV4, YOLOV5, SingleStageDetector

__all__ = ['YOLOV4', 'YOLOV5', 'SingleStageDetector']
