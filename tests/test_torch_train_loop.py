"""The port's training loop (``train_detector``, ``MosaicTileLoader``, the
CLI) on the CPU, and, as the check of the slice as a whole, its first two
steps on the host Mosaic chain against tpudet's ``DetDataLoader`` +
``make_train_step`` (jit, one CPU device) fed from the same seeds and
variables.

A tiny COCO set of JPEGs from a numpy seed; YOLOv4 at the v4s scale with
a 64-channel neck at 64 px, 2 classes; 2 images per micro-batch,
accumulation 2. The train chain is the flagship's (Mosaic, the affine
chain, HSV jitter, the box filter, Normalize) at 64 px (canvas 128, pad
to 192, crop 128). tpudet's variables with every BatchNorm scale at 0.25
(the random network at scale 1 is chaotic, ``test_torch_train_step.py``).

Tolerances of the whole-slice check (those of
``test_torch_train_step.py``): the loss of each step to rtol 1e-4 (step 1 as the log prints it, to its 4 decimals); params, BN
statistics, EMA copies and momentum buffers within 5e-3 of the largest
change the two steps made to them.
"""
import json
import os.path as osp
import random
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.apis.train import opt_config_from_cfg as jax_opt_config
from tpudet.config import Config as JaxConfig
from tpudet.data import build_dataset as jax_build_dataset
from tpudet.data.loader import DetDataLoader as JaxLoader
from tpudet.data.loader import MosaicTileLoader as JaxTileLoader
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step
from tpudet.utils.checkpoint import load_variables as jax_load_variables
from tpudet_torch.apis import train_detector
from tpudet_torch.config import Config
from tpudet_torch.data import MosaicTileLoader, build_dataset
from tpudet_torch.tools import train as train_cli
from tpudet_torch.utils.checkpoint import STATE_FILE, load_variables

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG, N_IMAGES, BN_SCALE = 64, 16, 0.25
NORM = dict(mean=[114, 114, 114], std=[255, 255, 255], to_rgb=True)
AUG = dict(pad_to=192, crop=128, scale_limit=0.5, pad_val=114., min_area=4.,
           min_visibility=0.2, min_size=2., max_aspect_ratio=20.,
           hue_ratio=0.015, saturation_ratio=0.7, value_ratio=0.4)
LOG = re.compile(r'epoch (\d+) step (\d+)/(\d+) loss ([\d.]+) \(bbox [\d.]+ '
                 r'cls [\d.]+ conf [\d.]+\) lr [\d.]+ gnorm [\d.]+ '
                 r'img/s [\d.]+')


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp('coco_loop')
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(N_IMAGES):
        h, w = (80, 100) if i % 4 else (100, 72)
        fn = f'img{i}.jpg'
        cv2.imwrite(str(root / fn), (rng.rand(h, w, 3) * 255).astype(
            np.uint8))
        images.append(dict(id=i + 1, file_name=fn, width=w, height=h))
        for _ in range(3):
            bw, bh = int(rng.randint(12, 40)), int(rng.randint(12, 36))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             bbox=[float(x), float(y), float(bw), float(bh)],
                             area=float(bw * bh), iscrowd=0,
                             category_id=int(rng.choice([1, 2]))))
    cats = [dict(id=1, name='a'), dict(id=2, name='b')]
    ann = root / 'ann.json'
    ann.write_text(json.dumps(dict(images=images, annotations=anns,
                                   categories=cats)))
    # the val set: the first 4 images
    (root / 'val.json').write_text(json.dumps(dict(
        images=images[:4], categories=cats,
        annotations=[a for a in anns if a['image_id'] <= 4])))
    return str(root), str(ann)


def cfg_dict(root, ann, device_aug=False, backend='turbojpeg'):
    load = [dict(type='LoadImageFromFile', im_decode_backend=backend),
            dict(type='LoadAnnotations', with_bbox=True),
            dict(type='Resize', img_scale=(IMG, IMG), keep_ratio=True)]
    host = [dict(type='MosaicPipeline', individual_pipeline=load,
                 pad_val=114),
            dict(type='RandomAffineChain', pad_to=192, crop=128,
                 scale_limit=0.5, out=IMG, hflip_p=0.5, pad_val=114,
                 min_area=4, min_visibility=0.2),
            dict(type='HueSaturationValueJitter', hue_ratio=0.015,
                 saturation_ratio=0.7, value_ratio=0.4),
            dict(type='GtBBoxesFilter', min_size=2, max_aspect_ratio=20),
            dict(type='Normalize', **NORM)]
    test = [dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(IMG, IMG), flip=False,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Pad', size_divisor=32),
                             dict(type='Normalize', **NORM)])]
    ds = dict(type='CocoDataset', ann_file=ann, img_prefix=root,
              classes=('a', 'b'))
    data = dict(samples_per_gpu=2, train_img_size=IMG, max_gts=8,
                train=dict(ds, pipeline=load if device_aug else host),
                val=dict(ds, ann_file=osp.join(root, 'val.json'),
                         pipeline=test, test_mode=True))
    if device_aug:
        data['device_aug'] = dict(AUG)
    return dict(
        model=dict(
            type='SingleStageDetector',
            backbone=dict(type='DarknetCSP', scale='v4s5p',
                          out_indices=[3, 4, 5]),
            neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
                      out_channels=[64, 64, 64], csp_repetition=1),
            bbox_head=dict(type='YOLOCSPHead', num_classes=2,
                           in_channels=[64, 64, 64]),
            test_cfg=dict(anchor_pre=256, nms_pre=-1, lane_pre=4,
                          class_pre=64, score_thr=0.001,
                          nms=dict(type='nms', iou_threshold=0.65),
                          max_per_img=10)),
        data=data, nominal_batch_size=4,
        optimizer=dict(lr=0.01, momentum=0.9, weight_decay=5e-4,
                       nesterov=True),
        optimizer_config=dict(grad_clip=dict(max_norm=35)),
        lr_config=dict(min_lr_ratio=0.2),
        custom_hooks=[
            dict(type='DetailedLinearWarmUpHook', warmup_iters=2),
            dict(type='StateEMAHook', momentum=0.999, warm_up=10)],
        runner=dict(max_epochs=1), evaluation=dict(interval=0),
        checkpoint_config=dict(interval=1), log_config=dict(interval=1),
        seed=0)


def write_cfg(path, cfg):
    """A config file of ``cfg``: one assignment per top-level key."""
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return str(path)


def log_lines(work_dir):
    with open(osp.join(work_dir, 'train.log')) as f:
        return f.read().splitlines()


@pytest.mark.parametrize('device_aug', [False, True],
                         ids=['host_chain', 'device_aug'])
def test_train_detector_steps_saves_and_resumes(coco, tmp_path, device_aug):
    cfg = Config(cfg_dict(*coco, device_aug=device_aug))
    if not device_aug:
        cfg['evaluation'] = dict(interval=1)
    wd = str(tmp_path)
    m = train_detector(cfg, wd, max_steps=2, device='cpu')
    assert np.isfinite(m['loss']) and m['grad_norm'] > 0
    steps = [LOG.search(line) for line in log_lines(wd)]
    steps = [s for s in steps if s]
    assert [(int(s[1]), int(s[2]), int(s[3])) for s in steps] == \
        [(0, 1, 2), (0, 2, 2)]
    assert abs(float(steps[-1][4]) - m['loss']) <= 5e-5
    assert osp.isfile(osp.join(wd, 'ckpts', '2', STATE_FILE))
    variables, meta = jax_load_variables(osp.join(wd, 'latest_ema.msgpack'))
    assert meta == dict(step=2, CLASSES=['a', 'b'])
    assert set(variables) == {'params', 'batch_stats'}
    assert osp.isfile(osp.join(wd, 'best_ema.msgpack')) != device_aug
    assert any('final param checksum' in line for line in log_lines(wd))

    cfg['evaluation'] = dict(interval=0)
    m3 = train_detector(cfg, wd, max_steps=3, device='cpu')
    lines = log_lines(wd)
    assert any(line.endswith('resumed from step 2') for line in lines)
    assert [s[2] for s in map(LOG.search, lines) if s] == ['1', '2', '3']
    assert osp.isfile(osp.join(wd, 'ckpts', '3', STATE_FILE))
    assert np.isfinite(m3['loss'])
    _, meta = load_variables(osp.join(wd, 'latest_ema.msgpack'))
    assert meta['step'] == 3
    # resumed at its horizon: no step, the same state published again
    assert train_detector(cfg, wd, max_steps=3, device='cpu') == {}
    assert [s[2] for s in map(LOG.search, log_lines(wd)) if s] == \
        ['1', '2', '3']


def test_mosaic_tile_loader_matches_tpudet(coco):
    root, ann = coco
    cfg = cfg_dict(root, ann, device_aug=True, backend='cv2')
    ref_ds = jax_build_dataset(cfg['data']['train'])
    got_ds = build_dataset(cfg['data']['train'], dict(device='cpu'))
    ref_l = JaxTileLoader(ref_ds, 4, tile_size=IMG, max_gts_per_tile=2,
                          seed=3)
    got_l = MosaicTileLoader(got_ds, 4, tile_size=IMG, max_gts_per_tile=2,
                             seed=3)
    ref_l.set_epoch(1)
    got_l.set_epoch(1)
    random.seed(3 + 1)
    ref_b, got_b = list(ref_l), list(got_l)
    assert len(got_b) == len(ref_b) == N_IMAGES // 4
    for g, r in zip(got_b, ref_b):
        assert g['tiles'].dtype == torch.uint8
        np.testing.assert_array_equal(g['tiles'].numpy(), r['tiles'])
        for k in ('tile_hw', 'gt_bboxes', 'gt_labels', 'gt_valid',
                  'aug_seed'):
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    # the per-tile padding cuts gts: every tile has 3 and keeps 2
    assert all(b['gt_valid'].sum(-1).max() == 2 for b in got_b)


@pytest.fixture(scope='module')
def slice_runs(coco, tmp_path_factory):
    """Two steps of tpudet's loader + jitted train step and of the port's
    ``train_detector``, from the same variables and seeds."""
    root, ann = coco
    cfg_d = cfg_dict(root, ann, backend='cv2')
    jcfg = JaxConfig(cfg_d)
    jmodel = jax_build_detector(jcfg['model'])
    jdataset = jax_build_dataset(jcfg['data']['train'])
    loader = JaxLoader(jdataset, batch_size=4, max_gts=8, img_size=IMG)
    spe = len(loader)
    jopt = jax_opt_config(jcfg, min(spe, 2), spe, 2)
    state0 = jax.device_get(jax_create_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jopt))
    scale = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda p, v: np.full_like(v, BN_SCALE) if p[-1].key == 'scale'
        else v, tree)
    state0 = state0.replace(params=scale(state0.params),
                            ema_params=scale(state0.ema_params))
    jstep = jax.jit(jax_make_train_step(
        jmodel, jopt, ema_momentum_base=0.999, ema_warm_up=10,
        ema_interval=1, accumulation=2))
    loader.set_epoch(0)
    random.seed(0)  # the port's loader seeds its dataset with seed + epoch
    jstate, jm = state0, []
    for batch in loader:
        batch.pop('img_metas')
        batch.pop('scale_factor')
        jstate, m = jstep(jstate, batch)
        jm.append({k: float(v) for k, v in m.items()})
        if len(jm) == 2:
            break
    variables = {'params': state0.params, 'batch_stats': state0.batch_stats}
    wd = str(tmp_path_factory.mktemp('port_run'))
    cfg_d['data']['train']['pipeline'] = cfg_dict(root, ann)['data'][
        'train']['pipeline']  # the port reads the files as 'turbojpeg'
    tm = train_detector(Config(cfg_d), wd, max_steps=2, device='cpu',
                        variables=variables, resume=False)
    trees, _ = load_variables(osp.join(wd, 'ckpts', '2', STATE_FILE))
    return state0, jax.device_get(jstate), jm, trees, tm, log_lines(wd)


def test_slice_losses_match_tpudet(slice_runs):
    _, _, jm, _, tm, lines = slice_runs
    logged = [float(s[4]) for s in map(LOG.search, lines) if s]
    assert len(logged) == 2
    assert abs(logged[0] - jm[0]['loss']) <= 5e-5 + 1e-4 * jm[0]['loss']
    for k in ('loss', 'loss_cls', 'loss_conf', 'loss_bbox', 'grad_norm',
              'lr', 'momentum', 'num_gts'):
        np.testing.assert_allclose(tm[k], jm[1][k], rtol=1e-4, err_msg=k)


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize('what', ['params', 'batch_stats', 'ema_params',
                                  'ema_batch_stats', 'momentum_buf'])
def test_slice_state_matches_tpudet(slice_runs, what):
    state0, jstate, _, trees, _, _ = slice_runs
    if what == 'momentum_buf':
        got, ref, init = (trees['opt_state']['momentum_buf'],
                          jstate.opt_state.momentum_buf,
                          state0.opt_state.momentum_buf)
    else:
        got, ref, init = trees[what], getattr(jstate, what), getattr(
            state0, what)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(_leaves(got), _leaves(ref)))
    upd = max(float(np.abs(a - b).max())
              for a, b in zip(_leaves(ref), _leaves(init)))
    assert upd > 0 and diff <= max(5e-3 * upd, 1e-6), (diff, upd)


def test_train_detector_defaults_to_cuda_and_raises_without_it(
        coco, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_detector(Config(cfg_dict(*coco)), str(tmp_path), max_steps=1)
    cfg_file = write_cfg(tmp_path / 'cfg.py', cfg_dict(*coco))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main([cfg_file, '--work-dir', str(tmp_path / 'w')])


def test_cli_trains_on_the_cpu(coco, tmp_path):
    cfg_file = write_cfg(tmp_path / 'cfg.py', cfg_dict(*coco))
    wd = tmp_path / 'w'
    m = train_cli.main([cfg_file, '--work-dir', str(wd), '--max-steps',
                        '1', '--device', 'cpu', '--seed', '3',
                        '--cfg-options', 'log_config.interval=1',
                        'data.samples_per_gpu=4'])
    assert np.isfinite(m['loss'])
    assert [s[2] for s in map(LOG.search, log_lines(str(wd))) if s] == ['1']
    assert 'accumulation 1' in log_lines(str(wd))[0]


@pytest.mark.parametrize('case', ['no_classes', 'batch_too_large'])
def test_empty_dataset_or_loader_raises(coco, tmp_path, case):
    cfg = Config(cfg_dict(*coco))
    if case == 'no_classes':
        cfg['data']['train']['classes'] = ('zebra',)
        match = 'dataset is empty'
    else:
        cfg['data']['samples_per_gpu'] = N_IMAGES
        cfg['nominal_batch_size'] = 2 * N_IMAGES
        match = 'loader yields 0 steps'
    with pytest.raises(ValueError, match=match):
        train_detector(cfg, str(tmp_path), device='cpu')


def test_nan_guard_dumps_the_state(coco, tmp_path):
    from tpudet_torch.models.builder import build_detector
    from tpudet_torch.utils.flax_import import random_flax_variables
    cfg = Config(cfg_dict(*coco))
    cfg['nan_guard'] = dict(enabled=True, interval=1)
    variables = random_flax_variables(build_detector(cfg['model']))
    head = variables['params']['bbox_head']['conv_pred0']
    head['bias'] = np.full_like(head['bias'], np.nan)
    with pytest.raises(FloatingPointError, match='nan_dump'):
        train_detector(cfg, str(tmp_path), max_steps=2, device='cpu',
                       variables=variables)
    assert osp.isfile(osp.join(str(tmp_path), 'nan_dump', '1', STATE_FILE))
    assert any('NaN guard tripped' in line for line in log_lines(
        str(tmp_path)))
