"""The port's test CLI (``python -m tpudet_torch.tools.test``) against
tpudet's ``tools/test.py``, on the CPU in fp32, and ``init_detector``
reading weights by path.

tpudet's ``save_variables`` writes one weights file (YOLOv5-s narrowed to
64 channels at the neck's two coarse levels, 3 classes, pred convs drawn
wide enough that scores clear ``score_thr``, ``CLASSES`` in its meta). A
config file names it and a set of JPEGs that cv2 wrote (longest side 128,
the test scale, so no resize); its ground truth is the three
top-scored detections of each image (from the port's ``single_device_test``
on these weights), so the reports are far from 0 and move with any
detection that differs. tpudet's CLI runs through ``runpy`` with
``sys.argv`` patched, the port's through ``main([...])``: the reports
agree within ``REPORT_ATOL`` of ``test_torch_test_flow.py`` and the
detection files in the COCO result format hold the same records per image
and category.
"""
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from tpudet.config import Config as JConfig
from tpudet.models.builder import build_detector as j_build_detector
from tpudet.utils.checkpoint import save_variables as j_save_variables
from tpudet_torch.apis import init_detector, single_device_test
from tpudet_torch.config import Config
from tpudet_torch.data import build_dataset
from tpudet_torch.tools import test as cli

from .test_torch_test_flow import (CLASSES, IMG, NO_RESIZE, REPORT_ATOL,
                                   _cfg, _variables, _write_set)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5S = os.path.join(ROOT, 'configs/yolov5/yolov5s_coco_mosaic.py')


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    d = _write_set(tmp_path_factory.mktemp('cli_set'), NO_RESIZE, 5)
    cfg_path = d / 'yolov5s_cli.py'
    cfg_path.write_text(f'''_base_ = {V5S!r}
model = dict(
    neck=dict(out_channels=[128, 64, 64]),
    bbox_head=dict(num_classes={len(CLASSES)}, in_channels=[128, 64, 64]),
    test_cfg=dict(anchor_pre=256, max_per_img=100))
data = dict(test=dict(ann_file={str(d / 'ann.json')!r},
                      img_prefix={str(d)!r}, classes={CLASSES!r},
                      pipeline={_cfg()['data']['test']['pipeline']!r}))
''')
    jmodel = j_build_detector(JConfig.fromfile(str(cfg_path))['model'])
    ckpt = str(d / 'weights.msgpack')
    j_save_variables(ckpt, _variables(jmodel, seed=3),
                     meta=dict(step=7, CLASSES=['a', 'b', 'c']))
    _detections_as_ground_truth(str(cfg_path), ckpt, d / 'ann.json')
    return d, str(cfg_path), ckpt


def _detections_as_ground_truth(cfg_path, ckpt, ann_file, per_image=3):
    det = init_detector(cfg_path, ckpt, device='cpu', dtype=torch.float32)
    cfg = Config.fromfile(cfg_path)
    ds = build_dataset({**cfg['data']['test'], 'test_mode': True},
                       dict(device='cpu'))
    results = single_device_test(det.model, ds, batch_size=2, img_size=IMG,
                                 progress=False)
    coco = json.loads(ann_file.read_text())
    anns = []
    for img_id, per_cls in zip(ds.img_ids, results):
        dets = sorted(((float(d[4]), c, d[:4]) for c, a in enumerate(per_cls)
                       for d in a), key=lambda t: -t[0])[:per_image]
        for _, c, (x1, y1, x2, y2) in dets:
            w, h = float(x2 - x1), float(y2 - y1)
            anns.append(dict(id=len(anns) + 1, image_id=int(img_id),
                             category_id=int(ds.cat_ids[c]),
                             bbox=[float(x1), float(y1), w, h], area=w * h,
                             iscrowd=0))
    ann_file.write_text(json.dumps(dict(coco, annotations=anns)))


def _args(cfg_path, ckpt, out, prefix):
    return [cfg_path, ckpt, '--batch-size', '2', '--img-size', str(IMG),
            '--out', out, '--format-out', prefix]


def _records(path):
    counts = {}
    for r in json.load(open(path)):
        key = (r['image_id'], r['category_id'])
        counts[key] = counts.get(key, 0) + 1
    return counts


def test_cli_report_matches_tpudets_tools_test(setup, monkeypatch, capsys):
    d, cfg_path, ckpt = setup
    ref_args = _args(cfg_path, ckpt, str(d / 'ref.json'), str(d / 'ref'))
    monkeypatch.setattr(sys, 'argv', ['tools/test.py'] + ref_args)
    runpy.run_path(os.path.join(ROOT, 'tools/test.py'), run_name='__main__')
    ref = json.load(open(d / 'ref.json'))

    got = cli.main(_args(cfg_path, ckpt, str(d / 'got.json'),
                         str(d / 'got')) + ['--device', 'cpu'])
    np.testing.assert_equal(json.load(open(d / 'got.json')), dict(got))
    assert list(got) == list(ref) == ['map', 'map50', 'map75', 's_map',
                                      'm_map', 'l_map']
    for k, v in ref.items():
        assert np.isnan(v) and np.isnan(got[k]) or \
            abs(got[k] - v) <= REPORT_ATOL, k
    assert ref['map50'] > 0.5
    printed = capsys.readouterr().out
    assert 'wrote bbox results to' in printed
    got_records = _records(str(d / 'got.bbox.json'))
    assert got_records == _records(str(d / 'ref.bbox.json'))
    assert sum(got_records.values()) > 50


def test_init_detector_reads_weights_and_classes_by_path(setup):
    _, cfg_path, ckpt = setup
    det = init_detector(cfg_path, ckpt, device='cpu', dtype=torch.float32)
    assert det.CLASSES == ('a', 'b', 'c')
    res = det(np.zeros((1, IMG, IMG, 3), np.float32))
    assert res.bboxes.shape == (1, 100, 4)
    with pytest.raises(ValueError, match='not both'):
        init_detector(cfg_path, ckpt, device='cpu', variables={})


@pytest.mark.parametrize('flags', [
    ['--tta'], ['--metrics', 'bbox', 'proposal_fast'],
    ['--coordinator', 'localhost:1234'], ['--num-processes', '2'],
    ['--process-id', '0']], ids=lambda f: '_'.join(f).strip('-'))
def test_cli_refuses_what_is_not_ported(flags):
    """``--tta`` and ``proposal_fast`` are ported now and no longer
    refused: the CLI takes them and goes on to read the config (which does
    not exist here); ``test_torch_tta.py`` holds their reports against
    tpudet's. The multi-process flags are ported: a multi-process run that
    lacks the coordinator or its process id is refused before anything
    runs."""
    if flags[0] in ('--tta', '--metrics'):
        with pytest.raises(FileNotFoundError):
            cli.main(['missing_cfg.py', '--device', 'cpu'] + flags)
        return
    if '--num-processes' not in flags:
        flags = flags + ['--num-processes', '2']
    with pytest.raises(ValueError, match='needs --coordinator and '
                                         '--process-id'):
        cli.main(['cfg.py', '--device', 'cpu'] + flags)


def test_cli_takes_segm_and_mask_thr_as_tpudet():
    args = cli.parse_args(['cfg.py', '--eval', 'bbox', 'segm',
                           '--mask-thr', '0.4'])
    assert args.metrics == ['bbox', 'segm'] and args.mask_thr == 0.4
    assert cli.parse_args(['cfg.py']).mask_thr == 0.5


def test_cli_defaults_to_cuda_and_raises_without_it(setup, monkeypatch):
    _, cfg_path, ckpt = setup
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([cfg_path, ckpt])
