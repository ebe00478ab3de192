from .yolocsp_head import YOLOCSPHead

__all__ = ['YOLOCSPHead']
