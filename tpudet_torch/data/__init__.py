from . import pipelines  # noqa: F401  (registers the transforms)
from .coco_api import COCO
from .dataset import COCO_CLASSES, CocoDataset, build_dataset
from .loader import DetDataLoader, MosaicTileLoader

__all__ = ['COCO', 'COCO_CLASSES', 'CocoDataset', 'build_dataset',
           'DetDataLoader', 'MosaicTileLoader']
