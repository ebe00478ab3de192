from .inference import Detector, init_detector

__all__ = ['Detector', 'init_detector']
