from .inference import (Detector, async_inference_detector,
                        inference_detector, init_detector,
                        nms_result_to_per_class)
from .test import single_device_test
from .train import (Trainer, evaluate_ema, init_trainer, opt_config_from_cfg,
                    train_detector)

__all__ = ['Detector', 'init_detector', 'inference_detector',
           'async_inference_detector',
           'nms_result_to_per_class', 'single_device_test', 'Trainer',
           'init_trainer', 'opt_config_from_cfg', 'train_detector', 'evaluate_ema']
