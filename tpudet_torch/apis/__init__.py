from .inference import Detector, init_detector
from .train import Trainer, init_trainer, opt_config_from_cfg

__all__ = ['Detector', 'init_detector', 'Trainer', 'init_trainer',
           'opt_config_from_cfg']
