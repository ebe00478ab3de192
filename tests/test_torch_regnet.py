"""RegNet in tpudet_torch against tpudet, on the CPU: ``generate_regnet``,
``adjust_width_group`` and ``out_channels`` for every entry of tpudet's
``ARCHS``, the ``regnetx_800mf`` backbone, and a narrow RegNet RetinaNet
(``regnetx_400mf``, an FPN of 32 channels, one stacked conv a branch, 3
classes, 64 px, batches of 2).

Tolerances:

- the stage tables equal (the same numpy steps);
- the backbone's stage outputs within 1e-4 of each output's largest
  |value| (fp32, the modules' yardstick);
- the RetinaNet's ``forward`` + ``loss`` in float64 on both sides: each
  loss rtol 1e-4, each parameter's gradient rtol 1e-4 with atol 1e-4 of
  its leaf's largest |value|;
- one train step (SGD, EMA; BatchNorm in train mode) in float64: losses
  and the gradient norm rtol 1e-4, the state within 5e-3 of the change
  the step made.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.config import Config as JaxConfig
from tpudet.models.backbones import regnet as jregnet
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step
from tpudet_torch.config import Config
from tpudet_torch.models.backbones import regnet
from tpudet_torch.models.builder import build_detector
from tpudet_torch.train.optim import YoloSGDConfig
from tpudet_torch.train.train_state import create_train_state, make_train_step
from tpudet_torch.utils.flax_import import (leaf_table, load_flax_variables,
                                            train_state_to_flax)

from .test_torch_backbone_neck import random_variables
from .test_torch_faster_rcnn_train import f64, state_dict_to_flax_grads
from .test_torch_gn_ws import _carry, _close, _nhwc, _t
from .test_torch_train_step import assert_tree_close
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, NUM_CLASSES = 64, 3


@pytest.mark.parametrize('arch', sorted(jregnet.RegNet.ARCHS))
def test_stage_tables_equal_tpudets(arch):
    assert regnet.RegNet.ARCHS[arch] == jregnet.RegNet.ARCHS[arch]
    p = jregnet.RegNet.ARCHS[arch]
    args = (p['w0'], p['wa'], p['wm'], p['depth'])
    assert regnet.generate_regnet(*args) == jregnet.generate_regnet(*args)
    assert regnet.RegNet.stage_config(arch) == \
        jregnet.RegNet.stage_config(arch)
    for idx in ((0, 1, 2, 3), (1, 3)):
        assert regnet.RegNet.out_channels(arch, idx) == \
            jregnet.RegNet.out_channels(arch, idx)


def test_the_configs_necks_take_the_backbones_widths():
    for name, arch in (('800MF', 'regnetx_800mf'), ('1.6GF', 'regnetx_1.6gf'),
                       ('3.2GF', 'regnetx_3.2gf')):
        cfg = Config.fromfile(os.path.join(
            ROOT, f'configs/regnet/retinanet_regnetx-{name}_fpn_1x_coco.py'))
        assert cfg['model']['backbone']['arch'] == arch
        assert tuple(cfg['model']['neck']['in_channels']) == \
            regnet.RegNet.out_channels(arch, (0, 1, 2, 3))


def test_regnetx_800mf_matches_tpudet():
    kw = dict(arch='regnetx_800mf')
    x = _nhwc(1, (2, IMG, IMG, 3))
    model = regnet.RegNet(**kw)
    _, ref = _carry(jregnet.RegNet(**kw), model, 2, x)
    with torch.no_grad():
        got = model.eval()(_t(x))
    assert [g.shape[1] for g in got] == [64, 128, 288, 672]
    assert [g.shape[2] for g in got] == [16, 8, 4, 2]  # strides 4-32
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1), r)
    assert model.stage2_block0.conv2.groups == 128 // 16


def regnet_retina_cfg():
    """The 3.2GF config's RetinaNet on ``regnetx_400mf``, narrowed."""
    cfg = JaxConfig.fromfile(os.path.join(
        ROOT, 'configs/regnet/retinanet_regnetx-3.2GF_fpn_1x_coco.py'))
    model = dict(cfg['model'])
    model['backbone'] = dict(model['backbone'], arch='regnetx_400mf')
    model['neck'] = dict(
        model['neck'], out_channels=32,
        in_channels=list(regnet.RegNet.out_channels('regnetx_400mf',
                                                    (0, 1, 2, 3))))
    model['bbox_head'] = dict(model['bbox_head'], num_classes=NUM_CLASSES,
                              in_channels=32, feat_channels=32,
                              stacked_convs=1)
    return model


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, 4, 4), np.float32)
    valid = np.zeros((b, 4), bool)
    for i, n in enumerate((4, 2)[:b]):
        xy = rng.rand(n, 2) * IMG * 0.6
        wh = rng.rand(n, 2) * IMG * 0.35 + 6
        boxes[i, :n] = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1)
        valid[i, :n] = True
    return dict(img=rng.uniform(-1.5, 1.5, (b, IMG, IMG, 3)),
                gt_bboxes=boxes,
                gt_labels=rng.randint(0, NUM_CLASSES, (b, 4)).astype(
                    np.int32),
                gt_valid=valid)


def test_retinanet_losses_and_gradients_match_tpudet_in_float64():
    cfg = regnet_retina_cfg()
    jmodel = jax_build_detector(cfg)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))), 3))
    batch = _batch(4)
    v64 = f64(variables)

    def total(params, img, boxes, labels, valid):
        maps, _ = jmodel.apply({'params': params,
                                'batch_stats': v64['batch_stats']}, img,
                               train=True, mutable=['batch_stats'])
        losses = jmodel.loss(maps, boxes, labels, valid)
        return sum(v for k, v in losses.items() if 'loss' in k), losses

    with jax.enable_x64(True):
        (_, jl), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
            v64['params'], *map(jnp.asarray, (
                batch['img'], batch['gt_bboxes'], batch['gt_labels'],
                batch['gt_valid'])))
        jl, jg = jax.device_get((jl, jg))
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    model.double().train()
    model.dtype = torch.float64
    maps = model(torch.from_numpy(batch['img']))
    tl = model.loss(maps, *(torch.from_numpy(batch[k]) for k in (
        'gt_bboxes', 'gt_labels', 'gt_valid')))
    assert set(tl) == set(jl)
    sum(v for k, v in tl.items() if 'loss' in k).backward()
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-4, err_msg=k)
    got = state_dict_to_flax_grads(
        model, {key: p.grad for key, p in model.named_parameters()})
    ref = jax.tree_util.tree_leaves_with_path(jg)
    assert len(got) == len(ref) == sum(
        1 for p in leaf_table(model) if p[0] == 'params')
    for path, r in ref:
        name = '/'.join(k.key for k in path)
        r = np.asarray(r)
        np.testing.assert_allclose(got[name], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
    assert np.abs(got['backbone/stage4_block0/conv2/kernel']).max() > 0


OPT = dict(lr=0.01, momentum=0.9, weight_decay=1e-4, nesterov=False,
           total_steps=50, warmup_iters=3, steps_per_epoch=0,
           grad_clip_norm=10.0, lr_weight_warmup_ratio=1.0,
           lr_bias_warmup_ratio=1.0, momentum_warmup_ratio=1.0)
EMA = dict(ema_momentum_base=0.9999, ema_warm_up=4, ema_interval=1)


def test_a_train_step_matches_tpudet_in_float64():
    cfg = regnet_retina_cfg()
    jmodel = jax_build_detector(cfg)
    jopt = JaxSGDConfig(**OPT)
    state0 = jax.device_get(jax.jit(
        lambda key, x: jax_create_state(jmodel, key, x, jopt))(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))
    state0 = jax.tree.map(lambda a: np.asarray(a, np.float64)
                          if a.dtype == np.float32 else a, state0)
    batch = _batch(5)
    with jax.enable_x64(True):
        jstate, jm = jax.device_get(jax.jit(jax_make_train_step(
            jmodel, jopt, **EMA))(state0, jax.tree.map(jnp.asarray, batch)))
    model = build_detector(cfg)
    load_flax_variables(model, {'params': state0.params,
                                'batch_stats': state0.batch_stats})
    model.double()
    model.dtype = torch.float64
    opt = YoloSGDConfig(**OPT)
    state, tm = make_train_step(model, opt, **EMA)(
        create_train_state(model, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ('loss', 'loss_cls', 'loss_bbox', 'num_gts', 'grad_norm', 'lr',
              'momentum'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert math.isfinite(float(jm['loss'])) and float(jm['grad_norm']) > 0
    tstate = train_state_to_flax(state, model)
    for what in ('params', 'batch_stats', 'ema_params', 'ema_batch_stats'):
        assert_tree_close(getattr(tstate, what), getattr(jstate, what),
                          getattr(state0, what), what)
    assert_tree_close(tstate.opt_state.momentum_buf,
                      jstate.opt_state.momentum_buf,
                      state0.opt_state.momentum_buf, 'momentum_buf')
