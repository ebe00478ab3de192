from .bfp import BFP
from .channel_mapper import ChannelMapper, DilatedEncoder
from .fpn import FPN
from .nas_fpn import NASFPN
from .nasfcos_fpn import NASFCOS_FPN
from .rfp import RFP
from .yolo_neck import YOLOV3Neck
from .yolo_neck_csp import YOLOV4Neck, YOLOV5Neck

__all__ = ['BFP', 'ChannelMapper', 'DilatedEncoder', 'FPN', 'NASFPN',
           'NASFCOS_FPN', 'RFP', 'YOLOV3Neck', 'YOLOV4Neck', 'YOLOV5Neck']
