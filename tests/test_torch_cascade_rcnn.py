"""Cascade R-CNN and the GN+WS Faster R-CNN in tpudet_torch against
tpudet, on the CPU: the detectors of ``test_torch_faster_rcnn.py``
(ResNet-18, an FPN of 64 channels, 3 classes, batches of 2) at 64 px with
tpudet's ``CascadeRoIHead`` (three stages) or with GN and weight
standardization everywhere and the ``Shared4Conv1FCBBoxHead`` (the
``configs/gn+ws/`` settings).

Tolerances, as ``test_torch_faster_rcnn.py`` and
``test_torch_faster_rcnn_train.py`` hold Faster R-CNN:

- forward (fp32, eval mode): every output within 1e-4 of its largest
  |value|, slot by slot (Cascade's twice-refined rois, mean class
  probabilities and last deltas; the GN+WS model's proposals, logits and
  deltas); the valid slots equal;
- ``get_bboxes`` of tpudet's own forward outputs: the keeps equal (boxes
  atol 1e-3 px, scores 1e-5), rescaled and clipped or not;
- end to end, each package on its own forward: detections one-to-one, at
  least 99 % of tpudet's;
- Cascade's ``forward_train`` in float64 on both sides: each loss rtol
  1e-4, each gradient rtol 1e-4 with atol 1e-4 of its leaf's largest
  |value| (GN's and WS's gradients: ``test_torch_gn_ws.py``);
- one step of tpudet's ``make_train_step`` against ``init_trainer`` in
  float64: losses and the gradient norm rtol 1e-4, the state within 5e-3
  of the change the step made;
- for these two, the RoI heads' weights are set so that every ReLU input
  of the heads is positive (``linear_heads``; asserted): both packages
  compute RoIAlign's sample points in fp32 from fp32 boxes, and round
  them differently (pooled features 2.6e-6 apart in float64, measured),
  so a head ReLU input that close to 0 takes another side in each; the
  4-conv head's 6 M ReLU inputs a layer always hold some, and such a flip
  moved one gradient leaf by 1 % of its largest value;
- ``train_detector`` (2 steps) and the test CLI on a narrowed
  ``configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py`` and
  ``configs/gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py``, the CLI's
  report equal to the API's within 1e-6.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.builder import build_detector as jax_build_detector
from tpudet_torch.apis import init_detector
from tpudet_torch.apis.train import forward_train_loss
from tpudet_torch.config import Config
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.detectors import FasterRCNN
from tpudet_torch.models.plugins import GroupNorm, WSConv
from tpudet_torch.models.roi_heads import (CascadeRCNN,
                                           Shared4Conv1FCBBoxHead)
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_faster_rcnn import (NUM_CLASSES, TOL, _t, _to_torch,
                                     assert_one_to_one, det_variables,
                                     frcnn_cfg)
from .test_torch_faster_rcnn_train import (_jax_losses,
                                           state_dict_to_flax_grads,
                                           tiny_config, two_stage_step_runs)
from .test_torch_roi_head import assert_detections_equal
from .test_torch_rpn_head import gts
from .test_torch_test_flow import NO_RESIZE, _write_set
from .test_torch_train_step import assert_tree_close
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KINDS = ['CascadeRCNN', 'GNWS']
IMG = 64


def _img(seed, b=2):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (b, IMG, IMG, 3)).astype(np.float32)


def _batch(img_seed):
    """The image in float64, ``gts(3)``'s boxes scaled to 64 px."""
    boxes, labels, valid = gts(3, size=IMG)
    return dict(img=_img(img_seed).astype(np.float64), gt_bboxes=boxes,
                gt_labels=labels, gt_valid=valid)


def zoo_cfg(kind, num_samples=64):
    """``frcnn_cfg()`` made a Cascade R-CNN, or given GN (32 groups) and WS
    in the backbone, GN in the neck and the 4-conv head with both."""
    cfg = frcnn_cfg(num_samples=num_samples)
    if kind == 'CascadeRCNN':
        cfg['type'] = 'CascadeRCNN'
        cfg['roi_head'] = dict(type='CascadeRoIHead', num_classes=NUM_CLASSES,
                               in_channels=64, num_samples=num_samples)
    else:
        cfg['backbone'] = dict(cfg['backbone'], norm='GN', conv_ws=True)
        cfg['neck'] = dict(cfg['neck'], norm='GN')
        cfg['roi_head'] = dict(cfg['roi_head'],
                               bbox_head_type='Shared4Conv1FCBBoxHead',
                               norm='GN', conv_ws=True)
    return cfg


@pytest.fixture(scope='module', params=KINDS)
def zoo_pair(request):
    kind = request.param
    cfg = zoo_cfg(kind)
    jmodel = jax_build_detector(cfg)
    img = _img(5)
    variables = det_variables(jmodel, (jnp.asarray(img),), 6)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = det.model(_t(img))
    return kind, cfg, jmodel, variables, det, img, ref, got


def _assert_close(got, ref):
    g, r = got.detach().numpy(), np.asarray(ref)
    assert g.shape == r.shape
    assert np.abs(g - r).max() <= TOL * np.abs(r).max()


def test_forward_outputs_match_tpudet(zoo_pair):
    kind, _, _, _, det, _, ref, got = zoo_pair
    model = det.model
    if kind == 'CascadeRCNN':
        assert type(model) is CascadeRCNN and len(got) == 5
        assert [n for n, _ in model.roi_head.named_children()] == [
            'bbox_head0', 'bbox_head1', 'bbox_head2']
        np.testing.assert_array_equal(got[4].numpy(), [IMG, IMG])
        # the mean of three softmaxes
        np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, atol=1e-5)
        assert got[3].shape[-1] == 4  # class-agnostic deltas
    else:
        assert type(model) is FasterRCNN
        assert isinstance(model.roi_head.bbox_head, Shared4Conv1FCBBoxHead)
        assert isinstance(model.neck.fpn_norm0, GroupNorm)
        assert isinstance(model.backbone.layer1_0.conv1, WSConv)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[1].sum(1).min()) > 100
    for i in (0, 2, 3):
        _assert_close(got[i], ref[i])


@pytest.mark.parametrize('clip', [True, False])
def test_detections_match_tpudet(zoo_pair, clip):
    _, _, jmodel, _, det, _, ref, got = zoo_pair
    kw, tkw = {}, {}
    if clip:
        sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
        hw = np.array([[IMG, IMG], [50, 45]], np.float32)
        kw = dict(scale_factors=jnp.asarray(sf),
                  img_shape=(jnp.asarray(hw[:, :1]), jnp.asarray(hw[:, 1:])))
        tkw = dict(scale_factors=_t(sf), img_shape=(_t(hw[:, :1]),
                                                    _t(hw[:, 1:])))
    rj = jax.jit(lambda out, kw: jmodel.get_bboxes(out, **kw))(ref, kw)
    assert_detections_equal(det.model.get_bboxes(_to_torch(ref), **tkw), rj)
    rt = det.model.get_bboxes(got, **tkw)
    assert_one_to_one(rt, rj, 1e-3)
    assert int(rt.valid.sum(1).min()) >= 10


def linear_heads(params):
    """``params`` with each RoI head's ReLU inputs moved above 0 (norm or
    FC biases raised, the next layer's kernel scaled down so that the
    logits stay near the unit range)."""
    params = jax.tree.map(np.array, params)
    heads = params['roi_head']
    for name, head in heads.items():
        if not name.startswith('bbox_head'):
            continue
        if 'shared_fc0' in head:  # Shared2FCBBoxHead
            head['shared_fc0']['bias'] += 30.
            head['shared_fc1']['kernel'] *= 0.1
            head['shared_fc1']['bias'] += 20.
        else:  # Shared4Conv1FCBBoxHead
            for i in range(4):
                head[f'shared_norm{i}']['bias'] += 10.
            head['shared_fc']['kernel'] *= 0.1
            head['shared_fc']['bias'] += 8.
        for out in ('fc_cls', 'fc_reg'):
            head[out]['kernel'] *= 0.05
    return params


def _assert_heads_linear(model, run):
    """``run()`` with every RoI head ReLU input positive."""
    low = []
    hooks = [m.register_forward_hook(lambda m, i, o: low.append(
        float(o.detach().min()))) for n, m in model.roi_head.named_modules()
        if n.split('.')[-1].startswith(('shared_fc', 'shared_norm'))]
    out = run()
    for h in hooks:
        h.remove()
    assert low and min(low) > 0, min(low)
    return out


def test_forward_train_losses_and_gradients_match_tpudet(zoo_pair):
    kind, cfg, jmodel, variables, _, _, _, _ = zoo_pair
    if kind != 'CascadeRCNN':
        return  # GN's and WS's gradients: test_torch_gn_ws.py
    variables = dict(variables, params=linear_heads(variables['params']))
    batch = _batch(7)
    jl, jg = _jax_losses(jmodel, variables, 'FasterRCNN', batch)
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    model.double().train()
    model.dtype = torch.float64
    tl = _assert_heads_linear(model, lambda: forward_train_loss(model)(
        {k: _t(v) for k, v in batch.items()}))
    assert set(tl) == set(jl)
    assert {f'loss_{t}_s{i}' for t in ('cls', 'bbox')
            for i in range(3)} <= set(tl)
    sum(v for k, v in tl.items() if 'loss' in k).backward()
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-4, err_msg=k)
    got = state_dict_to_flax_grads(
        model, {key: p.grad for key, p in model.named_parameters()})
    ref = jax.tree_util.tree_leaves_with_path(jg)
    assert len(got) == len(ref)
    for path, r in ref:
        name = '/'.join(k.key for k in path)
        r = np.asarray(r)
        np.testing.assert_allclose(got[name], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)
    for i in range(3):  # every stage's head learns
        assert np.abs(got[f'roi_head/bbox_head{i}/fc_reg/kernel']).max() > 0


@pytest.mark.parametrize('kind', KINDS)
def test_a_train_step_matches_tpudet(kind):
    init, state0, jstate, jm, tstate, tm = two_stage_step_runs(
        zoo_cfg(kind, num_samples=16), 1, adjust=linear_heads,
        batch_fn=lambda step: _batch(20 + step))
    assert_tree_close(init.params, state0.params, state0.params, 'init')
    keys = {'loss', 'loss_rpn_cls', 'loss_rpn_bbox', 'num_gts', 'grad_norm',
            'lr', 'momentum'} | {k for k in jm[0] if k.startswith('loss_')}
    for k in keys:
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-4, err_msg=k)
    assert math.isfinite(jm[0]['loss']) and jm[0]['grad_norm'] > 0
    for what in ('params', 'batch_stats', 'ema_params'):
        got, ref = getattr(tstate, what), getattr(jstate, what)
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        if jax.tree.leaves(ref):  # GN+WS has no BatchNorm statistics
            assert_tree_close(got, ref, getattr(state0, what), what)
    assert bool(jax.tree.leaves(jstate.batch_stats)) == (kind != 'GNWS')
    assert_tree_close(tstate.opt_state.momentum_buf,
                      jstate.opt_state.momentum_buf,
                      state0.opt_state.momentum_buf, 'momentum_buf')


ZOO_CONFIGS = {
    'CascadeRCNN': ('configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py',
                    "roi_head=dict(num_classes=3, in_channels=32, "
                    "num_samples=128)"),
    'GNWS': ('configs/gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py',
             "roi_head=dict(num_classes=3, in_channels=32, num_samples=64)")}


@pytest.mark.parametrize('kind', KINDS)
def test_train_detector_and_the_test_cli_take_the_config(tmp_path, kind):
    """``train_detector`` (2 steps, a checkpoint, the EMA evaluation) and
    the test CLI on its weights, equal to ``single_device_test`` +
    ``coco_fast_bbox_eval``, on the family's config narrowed as
    ``tiny_config`` narrows Faster R-CNN's."""
    from tpudet_torch.apis import single_device_test, train_detector
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import coco_fast_bbox_eval
    from tpudet_torch.tools import test as cli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _write_set(tmp_path, NO_RESIZE[:4], 17)
    base, roi = ZOO_CONFIGS[kind]
    path = tmp_path / 'zoo_tiny.py'
    text = open(tiny_config(tmp_path, root)).read()
    text = text.replace(repr(os.path.join(root, 'configs/faster_rcnn/'
                                          'faster_rcnn_r50_fpn_1x_coco.py')),
                        repr(os.path.join(root, base)))
    text = text.replace('roi_head=dict(num_classes=3, in_channels=32, '
                        'num_samples=128)', roi)
    if kind == 'GNWS':  # 32 channels in 8 groups
        text = text.replace('out_channels=32)', 'out_channels=32, '
                            'gn_groups=8)')
    path.write_text(text)
    cfg = Config.fromfile(str(path))
    assert cfg['model']['type'] == ('CascadeRCNN' if kind == 'CascadeRCNN'
                                    else 'FasterRCNN')
    work = str(tmp_path / 'work')
    metrics = train_detector(cfg, work, max_steps=2, device='cpu')
    assert math.isfinite(metrics['loss'])
    weights = os.path.join(work, 'latest_ema.msgpack')
    report = cli.main([str(path), weights, '--img-size', '128', '--device',
                       'cpu'])
    det = init_detector(cfg, weights, device='cpu', dtype=torch.float32)
    ds = build_dataset({**cfg['data']['test'], 'test_mode': True},
                       dict(device='cpu'))
    ref = coco_fast_bbox_eval(
        single_device_test(det.model, ds, batch_size=8, img_size=128,
                           progress=False),
        [ds.get_ann_info_test(i) for i in range(len(ds))],
        classes=ds.CLASSES)
    assert list(report) == list(ref)
    np.testing.assert_allclose([report[k] for k in ref],
                               [ref[k] for k in ref], atol=1e-6)
