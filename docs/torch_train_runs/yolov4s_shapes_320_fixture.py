# configs/shapes/yolov4s_shapes_320.py on the committed shapes set
# (tests/torch_fixtures/shapes, written by
#   python tools/misc/synth_shapes.py tests/torch_fixtures/shapes \
#       --train 64 --val 32 --size 320
# from seed 0). The paths are relative to the repo root, where the CLIs
# run. Two processes take samples_per_gpu=4 each (global batch 8, as the
# recipe's one process): --cfg-options data.samples_per_gpu=4.
_base_ = '../../configs/shapes/yolov4s_shapes_320.py'

data = dict(
    train=dict(ann_file='tests/torch_fixtures/shapes/train.json',
               img_prefix='tests/torch_fixtures/shapes/train/images/'),
    val=dict(ann_file='tests/torch_fixtures/shapes/val.json',
             img_prefix='tests/torch_fixtures/shapes/val/images/'),
    test=dict(ann_file='tests/torch_fixtures/shapes/val.json',
              img_prefix='tests/torch_fixtures/shapes/val/images/'))
