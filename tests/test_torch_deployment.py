"""The port's deployment chain on the CPU in fp32, as tpudet's
``tests/test_runtime/test_deployment_loop.py`` chains its own: the
narrow v4s model at 64 px trained 2 steps by ``train_detector`` ->
``publish_model`` of its train state -> live eval (``single_device_test``
+ ``coco_fast_bbox_eval``) -> ``export_eval_artifact`` -> deployed eval
through ``deployment_test`` (API and CLI), with the tool scripts of the
slice against tpudet's.

The test set's ground truth is the live model's three best detections of
each image (written after the live eval), so that the reports are far
from 0 and move with any detection that differs. Batch 3 over 8 images
leaves a tail batch of 2, which the deployed program zero-pads.

Tolerances:
- deployed against live: the full batches bit-equal (the same ATen ops
  on the same CPU); the tail batch within 1e-5, since the CPU's
  convolutions sum a batch of 3 in another order than a batch of 2; the
  reports equal;
- the port's deployed eval against tpudet's ``jax.export`` eval of the
  same published weights: per class within 1e-4 (boxes in px, scores),
  as ``test_torch_test_flow.py``; the reports equal;
- ``publish_model``, ``print_config``, ``get_flops``' params and
  ``coco_error_analysis`` equal tpudet's.
"""
import hashlib
import importlib.util
import json
import os.path as osp
import runpy
import sys

import cv2
import numpy as np
import pytest
import torch

from tpudet_torch.apis import init_detector, single_device_test
from tpudet_torch.apis.train import train_detector
from tpudet_torch.config import Config
from tpudet_torch.data import build_dataset
from tpudet_torch.evaluation import coco_fast_bbox_eval
from tpudet_torch.tools import (coco_error_analysis, deployment_test,
                                export_program, get_flops, print_config,
                                publish_model)
from tpudet_torch.utils.checkpoint import load_variables

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
BATCH, IMG = 3, 64
TAIL_TOL, TPUDET_TOL = 1e-5, 1e-4

MODEL = dict(
    type='SingleStageDetector',
    backbone=dict(type='DarknetCSP', scale='v4s5p', out_indices=[3, 4, 5]),
    neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
              out_channels=[64, 64, 64], csp_repetition=1),
    bbox_head=dict(type='YOLOCSPHead', num_classes=1,
                   in_channels=[64, 64, 64]),
    train_cfg=dict(),
    test_cfg=dict(min_bbox_size=0, nms_pre=-1, score_thr=0.01,
                  anchor_pre=256, class_pre=32,
                  nms=dict(type='nms', iou_threshold=0.65),
                  max_per_img=10))


def _load_tool(name, rel):
    spec = importlib.util.spec_from_file_location(name, osp.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_set(root):
    """8 JPEGs of 64 px with a filled rectangle each (tpudet's loop test);
    ``ann.json`` to train on and ``test.json`` to evaluate on."""
    rng = np.random.RandomState(3)
    images, annotations = [], []
    for i in range(8):
        img = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        x, y = rng.randint(4, 30, 2)
        w, h = rng.randint(16, 30, 2)
        cv2.rectangle(img, (x, y), (x + w, y + h), (0, 255, 0), -1)
        cv2.imwrite(str(root / f'img{i}.jpg'), img)
        images.append(dict(id=i + 1, file_name=f'img{i}.jpg', width=64,
                           height=64))
        annotations.append(dict(id=i + 1, image_id=i + 1, category_id=1,
                                bbox=[int(x), int(y), int(w), int(h)],
                                area=int(w * h), iscrowd=0))
    coco = dict(images=images, annotations=annotations,
                categories=[dict(id=1, name='thing')])
    for name in ('ann.json', 'test.json'):
        (root / name).write_text(json.dumps(coco))


CONFIG = """
model = {model!r}
img_norm_cfg = dict(mean=[114, 114, 114], std=[255, 255, 255], to_rgb=True)
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=(64, 64), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='Normalize', **img_norm_cfg),
]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=(64, 64), flip=False,
         transforms=[
             dict(type='Resize', keep_ratio=True),
             dict(type='RandomFlip'),
             dict(type='Pad', size_divisor=32),
             dict(type='Normalize', **img_norm_cfg),
         ]),
]
data = dict(
    samples_per_gpu=1, workers_per_gpu=0, train_img_size=64, max_gts=4,
    train=dict(type='CocoDataset', ann_file='{root}/ann.json',
               img_prefix='{root}/', classes=('thing',),
               pipeline=train_pipeline),
    test=dict(type='CocoDataset', ann_file='{root}/test.json',
              img_prefix='{root}/', classes=('thing',),
              pipeline=test_pipeline, test_mode=True))
optimizer = dict(lr=0.001, momentum=0.9, weight_decay=5e-4, nesterov=True)
optimizer_config = dict(grad_clip=dict(max_norm=10))
lr_config = dict(min_lr_ratio=0.2)
custom_hooks = [dict(type='StateEMAHook', momentum=0.99,
                     nominal_batch_size=8, warm_up=10)]
runner = dict(max_epochs=1)
evaluation = dict(interval=0)
checkpoint_config = dict(interval=1)
log_config = dict(interval=1)
seed = 0
"""


def _detections_as_ground_truth(results, ds, path, per_image=3):
    coco = json.loads(path.read_text())
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
    path.write_text(json.dumps(dict(coco, annotations=anns)))


def _dataset(cfg):
    return build_dataset({**cfg['data']['test'], 'test_mode': True},
                         dict(device='cpu'))


def _report(results, ds):
    anns = [ds.get_ann_info_test(i) for i in range(len(ds))]
    return coco_fast_bbox_eval(results, anns, classes=ds.CLASSES)


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_deploy')
    _write_set(root)
    cfg_path = root / 'cfg.py'
    cfg_path.write_text(CONFIG.format(model=MODEL, root=root))
    cfg = Config.fromfile(str(cfg_path))

    # 1. train -> the train state and latest_ema.msgpack
    work = root / 'work'
    train_detector(cfg, str(work), max_steps=2, resume=False, device='cpu')
    # 2. publish the train state's EMA weights
    published = publish_model.main([str(work / 'ckpts'),
                                    str(root / 'yolo.msgpack')])
    # 3. live eval from the published file; its detections become the
    # test set's ground truth
    det = init_detector(cfg, published, device='cpu', dtype=torch.float32)
    live = single_device_test(det.model, _dataset(cfg), batch_size=BATCH,
                              img_size=IMG, progress=False)
    _detections_as_ground_truth(live, _dataset(cfg), root / 'test.json')
    # 4. export, 5. deployed eval
    artifact = str(root / 'yolo.pt2')
    n_bytes = export_program.export_eval_artifact(det, artifact, batch=BATCH,
                                                  img_size=IMG)
    infer_fn = deployment_test.load_exported_infer_fn(artifact, BATCH, IMG)
    ds = _dataset(cfg)
    deployed = single_device_test(det.model, ds, batch_size=BATCH,
                                  img_size=IMG, progress=False,
                                  infer_fn=infer_fn)
    return dict(root=root, cfg_path=str(cfg_path), cfg=cfg, work=work,
                published=published, live=live, deployed=deployed,
                artifact=artifact, n_bytes=n_bytes, ds=ds,
                rep_live=_report(live, ds))


def test_chain_deployed_eval_equals_live(chain):
    live, deployed = chain['live'], chain['deployed']
    assert chain['n_bytes'] > 1e6
    assert len(live) == len(deployed) == 8
    assert sum(len(a) for r in live for a in r) >= 8
    full = len(live) // BATCH * BATCH
    for i, (lv, dp) in enumerate(zip(live, deployed)):
        for lc, dc in zip(lv, dp):
            assert lc.shape == dc.shape
            if i < full:
                np.testing.assert_array_equal(lc, dc)
            else:
                np.testing.assert_allclose(lc, dc, rtol=TAIL_TOL,
                                           atol=TAIL_TOL)
    rep = _report(deployed, chain['ds'])
    assert chain['rep_live']['map50'] > 0.5
    np.testing.assert_equal(dict(rep), dict(chain['rep_live']))


def test_deployed_eval_matches_tpudets_jax_export(chain):
    from tpudet.apis.inference import init_detector as j_init_detector
    from tpudet.apis.test import single_device_test as j_test
    from tpudet.config import Config as JConfig
    from tpudet.data.dataset import build_dataset as j_build_dataset

    cfg = JConfig.fromfile(chain['cfg_path'])
    det = j_init_detector(cfg, chain['published'])
    artifact = str(chain['root'] / 'yolo.jaxexp')
    _load_tool('export_t13', 'tools/deployment/export_stablehlo.py'
               ).export_eval_artifact(det, artifact, batch=BATCH,
                                      img_size=IMG)
    deploy = _load_tool('deploy_t13', 'tools/deployment/test.py')
    ds = j_build_dataset({**cfg['data']['test'], 'test_mode': True})
    ref = j_test(det.model, None, ds, batch_size=BATCH, img_size=IMG,
                 progress=False, infer_fn=deploy.load_exported_infer_fn(
                     artifact, BATCH, img_size=IMG))
    for rv, gv in zip(ref, chain['deployed']):
        for rc, gc in zip(rv, gv):
            assert rc.shape == gc.shape
            np.testing.assert_allclose(gc, rc, rtol=0, atol=TPUDET_TOL)
    np.testing.assert_equal(dict(_report(chain['deployed'], chain['ds'])),
                            dict(_report(ref, chain['ds'])))
    # the shape checks exit with tpudet's words
    for batch, img in ((2, IMG), (BATCH, 2 * IMG)):
        with pytest.raises(SystemExit) as want:
            deploy.load_exported_infer_fn(artifact, batch, img_size=img)
        with pytest.raises(SystemExit) as got:
            deployment_test.load_exported_infer_fn(chain['artifact'], batch,
                                                   img_size=img)
        assert str(got.value) == str(want.value)


def test_deployment_cli_report_equals_live(chain, capsys):
    out = chain['root'] / 'report.json'
    report = deployment_test.main([
        chain['cfg_path'], chain['artifact'], '--batch-size', str(BATCH),
        '--img-size', str(IMG), '--out', str(out), '--device', 'cpu'])
    np.testing.assert_equal(dict(report), dict(chain['rep_live']))
    np.testing.assert_equal(json.loads(out.read_text()), dict(report))
    assert json.loads(capsys.readouterr().out) == json.loads(
        out.read_text())


def test_publish_train_state_loads_in_tpudet(chain):
    from tpudet.utils.checkpoint import load_variables as j_load_variables

    ckpts = str(chain['work'] / 'ckpts')
    state, _ = load_variables(str(chain['work'] / 'ckpts' / '2' /
                                  'train_state.msgpack'))
    raw = publish_model.main([ckpts, str(chain['root'] / 'raw.msgpack'),
                              '--raw'])
    for path, prefix, ema in ((chain['published'], 'ema_', True),
                              (raw, '', False)):
        name = osp.basename(path)
        with open(path, 'rb') as f:
            sha = hashlib.sha256(f.read()).hexdigest()[:8]
        assert name.endswith(f'-{sha}.msgpack')
        tree, meta = j_load_variables(path)
        assert meta == {'published_from': ckpts, 'ema': ema}
        for part in ('params', 'batch_stats'):
            want = _flat(state[prefix + part])
            got = _flat(tree[part])
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}/{k}'))
        return out
    return {prefix: np.asarray(tree)}


def test_publish_msgpack_and_refuse_orbax(chain):
    from tpudet.utils.checkpoint import load_variables as j_load_variables

    src = str(chain['work'] / 'latest_ema.msgpack')
    path = publish_model.main([src, str(chain['root'] / 'again.msgpack')])
    tree, meta = j_load_variables(path)
    src_tree, src_meta = load_variables(src)
    assert meta == dict(src_meta, published_from=src)
    got, want = _flat(tree), _flat(src_tree)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)
    orbax = chain['root'] / 'orbax' / '2'
    orbax.mkdir(parents=True)
    (orbax / '_CHECKPOINT_METADATA').write_text('{}')
    with pytest.raises(SystemExit, match="reading tpudet's orbax "
                                         "train-state directories"):
        publish_model.main([str(orbax.parent), str(chain['root'] / 'x')])


def _run_tpudet_tool(rel, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, 'argv', [rel] + argv)
    runpy.run_path(osp.join(REPO, rel), run_name='__main__')
    return capsys.readouterr().out


def test_print_config_equals_tpudets(chain, monkeypatch, capsys):
    cfg = osp.join(REPO, 'configs/yolov4/yolov4l_coco_mosaic.py')
    argv = [cfg, '--cfg-options', 'model.bbox_head.num_classes=3',
            'data.samples_per_gpu=4', "optimizer.type='SGD'"]
    want = _run_tpudet_tool('tools/misc/print_config.py', argv, monkeypatch,
                            capsys)
    got = print_config.main(argv)
    assert capsys.readouterr().out == want
    assert got + '\n' == want and "'num_classes': 3" in got


@pytest.mark.parametrize('config', [
    None, 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py'])
def test_get_flops_params_equal_tpudets(chain, config, capsys):
    """tpudet's ``get_flops`` counts the leaves of ``model.init``'s
    ``params``; ``jax.eval_shape`` gives the same tree without running
    it. The FLOPs (convolutions and matmuls, not XLA's count) are only
    checked to be printed and positive."""
    import jax
    import jax.numpy as jnp

    from tpudet.config import Config as JConfig
    from tpudet.models.builder import build_detector as j_build_detector

    path = chain['cfg_path'] if config is None else osp.join(REPO, config)
    size = IMG if config is None else 128
    shapes = jax.eval_shape(
        j_build_detector(JConfig.fromfile(path)['model']).init,
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes['params']))
    n_params, flops = get_flops.main([path, '--shape', str(size)])
    printed = capsys.readouterr().out
    assert n_params == want
    assert f'Params: {want / 1e6:.2f} M ({want})' in printed
    assert 'FLOPs (FlopCounterMode, convolutions and matmuls only)' in \
        printed
    assert flops > 2 * n_params


def test_coco_error_analysis_equals_tpudets(chain):
    j_tool = _load_tool('cea_t13',
                        'tools/analysis_tools/coco_error_analysis.py')
    ds = chain['ds']
    anns = [ds.get_ann_info_test(i) for i in range(len(ds))]
    want = j_tool.analyse(chain['live'], anns, ds.CLASSES)
    got = coco_error_analysis.analyse(chain['live'], anns, ds.CLASSES)
    np.testing.assert_equal(got, want)
    assert want['C50'] > 0.5
    out = chain['root'] / 'errors.json'
    report = coco_error_analysis.main([
        chain['cfg_path'], chain['published'], '--batch-size', str(BATCH),
        '--img-size', str(IMG), '--out', str(out), '--device', 'cpu'])
    np.testing.assert_equal(report, want)
    np.testing.assert_equal(json.loads(out.read_text()), want)
