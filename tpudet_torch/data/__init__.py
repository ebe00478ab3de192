from . import pipelines  # noqa: F401  (registers the transforms)
from .coco_api import COCO
from .custom import (ClassBalancedDataset, ConcatDataset, CustomDataset,
                     GarbageDataset, RepeatDataset, TrafficSignDataset,
                     VOCDataset, XMLDataset)
from .dataset import (COCO_CLASSES, CityscapesDataset, CocoDataset,
                      DeepFashionDataset, LVISDataset, WIDERFaceDataset,
                      build_dataset)
from .loader import DetDataLoader, MosaicTileLoader

__all__ = ['COCO', 'COCO_CLASSES', 'CocoDataset', 'build_dataset',
           'CityscapesDataset', 'WIDERFaceDataset', 'DeepFashionDataset',
           'LVISDataset', 'CustomDataset', 'TrafficSignDataset',
           'GarbageDataset', 'XMLDataset', 'VOCDataset', 'ConcatDataset',
           'RepeatDataset', 'ClassBalancedDataset', 'DetDataLoader',
           'MosaicTileLoader']
