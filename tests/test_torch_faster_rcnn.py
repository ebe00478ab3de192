"""The two-stage family as a whole: the port's ``FasterRCNN``, ``RPN`` and
``FastRCNN`` against tpudet's, on the CPU in fp32 (ResNet-18, an FPN of
64 channels, 3 classes, 128 px, batches of 2, random kernels N(0,
1/fan_in) and BatchNorm statistics around identity from a numpy seed);
training is in ``test_torch_faster_rcnn_train.py``.

Tolerances:

- forward outputs (BatchNorm in eval mode, fp32): the pred maps, and the
  RoI head's logits and deltas, within 1e-4 of each map's largest
  |value|;
- ``get_bboxes`` of tpudet's own forward outputs: the keeps equal, as in
  ``test_torch_rpn_head.py`` / ``test_torch_roi_head.py`` (``valid``,
  labels and slots equal, boxes atol 1e-4 px for proposals and 1e-3 px
  for detections, scores atol 1e-5); rescaled and clipped to per-image
  shapes or not; ``RPN``'s proposals with ``min_bbox_size``;
- end to end, each package on its own forward: the proposals and the
  detections one-to-one, as many valid per image to 1 %, at least 99 %
  of tpudet's matched by one of the port's (same label, boxes and scores
  as above). The network's fp32 rounding (~1e-5 on the logits) may swap
  two near-tied candidates or flip one NMS decision near the IoU
  threshold: measured, 1 proposal of ~1,000 for ``RPN``;
- the weights and the train state (SGD and Adam buffers) cross to tpudet's
  layout and back byte-equal, Dense kernels (in, out) and ``shared_fc0``'s
  HWC rows included; ``random_flax_variables`` draws each Dense by its
  initializer; the optimiser's group labels equal tpudet's.
"""
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.train.optim import param_group_label
from tpudet_torch.apis import init_detector
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.detectors import RPN, FasterRCNN, FastRCNN
from tpudet_torch.train.optim import YoloSGDConfig, param_labels
from tpudet_torch.utils.flax_import import (flax_to_state_dict, leaf_table,
                                            load_flax_variables,
                                            random_flax_variables,
                                            state_dict_to_flax,
                                            train_state_from_flax,
                                            train_state_to_flax)

from .test_torch_backbone_neck import random_variables
from .test_torch_roi_head import assert_detections_equal
from .test_torch_rpn_head import assert_proposals_equal, gts
from .test_torch_train_step import _leaves

IMG, NUM_CLASSES = 128, 3
TOL = 1e-4
BACKBONE = dict(type='ResNet', depth=18, out_indices=[0, 1, 2, 3])
NECK = dict(type='FPN', in_channels=[64, 128, 256, 512], out_channels=64,
            num_outs=5)
RCNN_TEST = dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                 max_per_img=100)


def frcnn_cfg(kind='FasterRCNN', num_samples=512):
    """tpudet's test detector of the family (``tests/test_runtime/
    test_overfit_two_stage.py``) at 128 px, with the config's RPN
    settings."""
    rpn_test = dict(nms_pre=1000, max_per_img=1000,
                    nms=dict(iou_threshold=0.7))
    cfg = dict(type=kind, backbone=BACKBONE, neck=NECK)
    if kind != 'FastRCNN':
        cfg['rpn_head'] = dict(type='RPNHead', in_channels=64,
                               feat_channels=64)
    if kind != 'RPN':
        cfg['roi_head'] = dict(type='StandardRoIHead',
                               num_classes=NUM_CLASSES, in_channels=64,
                               num_samples=num_samples)
    if kind == 'FasterRCNN':
        cfg['train_cfg'] = dict(rpn_proposal=dict(
            nms_pre=2000, max_per_img=1000, nms=dict(iou_threshold=0.7)))
        cfg['test_cfg'] = dict(rpn=rpn_test, rcnn=RCNN_TEST)
    elif kind == 'RPN':
        cfg['test_cfg'] = dict(rpn=dict(rpn_test, min_bbox_size=4.0))
    else:
        cfg['test_cfg'] = dict(rcnn=RCNN_TEST)
    return cfg


def _t(a):
    return torch.tensor(np.asarray(a))


def _img(seed, b=2):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (b, IMG, IMG, 3)).astype(np.float32)


def _proposals(seed, b=2, n=300):
    """Proposals for ``FastRCNN``: jittered copies of ``gts(3)``'s boxes
    and random ones, a tenth not valid."""
    rng = np.random.RandomState(seed)
    boxes, _, valid = gts(3, b=b)
    out = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        src = boxes[i][valid[i]][rng.randint(0, valid[i].sum(), n)]
        wh = (src[:, 2:] - src[:, :2])[:, [0, 1, 0, 1]]
        out[i] = src + rng.uniform(-0.4, 0.4, (n, 4)) * wh
    return out, rng.rand(b, n) > 0.1


def _jax_init_args(kind, img):
    if kind == 'FastRCNN':
        props, valid = _proposals(4)
        return (jnp.asarray(img), jnp.asarray(props), jnp.asarray(valid))
    return (jnp.asarray(img),)


def det_variables(jmodel, args, seed):
    """``random_variables`` with the RPN's deltas drawn 10x narrower, so
    that proposals keep sizes near their anchors': at N(0, 1/fan_in) the
    deltas reach the coder's clamp, boxes grow to ~60x their anchors before
    the clip, and the pred maps' fp32 rounding (~1e-6 of the largest
    value) moves them by more than 1e-4 px."""
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), *args), seed))
    reg = variables['params'].get('rpn_head', {}).get('rpn_reg')
    if reg is not None:
        reg['kernel'] = reg['kernel'] * 0.1
        reg['bias'] = reg['bias'] * 0.1
    return variables


@pytest.fixture(scope='module', params=['FasterRCNN', 'RPN', 'FastRCNN'])
def pair(request):
    kind = request.param
    cfg = frcnn_cfg(kind)
    jmodel = jax_build_detector(cfg)
    img = _img(5)
    args = _jax_init_args(kind, img)
    variables = det_variables(jmodel, args, 6)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    ref = jmodel.apply(variables, *args)
    with torch.no_grad():
        got = det.model(*[_t(a) for a in args])
    return kind, cfg, jmodel, variables, det, args, ref, got


def assert_one_to_one(got, ref, box_atol, score_atol=1e-5, share=0.99):
    """``got`` and ``ref`` as (boxes, scores, labels, valid): per image as
    many valid to ``1 - share``, and at least ``share`` of ``ref``'s valid
    each paired with an unused one of ``got``'s of the same label, boxes
    within ``box_atol`` px and scores within ``score_atol``."""
    gb, gs, gl, gv = (np.asarray(t) for t in got)
    rb, rs, rl, rv = (np.asarray(t) for t in ref)
    for i in range(len(gv)):
        n = int(rv[i].sum())
        assert abs(int(gv[i].sum()) - n) <= (1 - share) * n, i
        g_box, r_box = gb[i][gv[i]], rb[i][rv[i]]
        ok = ((np.abs(r_box[:, None] - g_box[None]).max(-1) <= box_atol) &
              (np.abs(rs[i][rv[i]][:, None] - gs[i][gv[i]][None]) <=
               score_atol) &
              (rl[i][rv[i]][:, None] == gl[i][gv[i]][None]))
        used = np.zeros(len(g_box), bool)
        for r in range(len(r_box)):
            cand = np.nonzero(ok[r] & ~used)[0]
            if len(cand):
                used[cand[0]] = True
        assert used.sum() >= share * n, (i, int(used.sum()), n)


def _assert_maps_close(got, ref):
    g, r = got.detach().numpy(), np.asarray(ref)
    assert g.shape == r.shape
    assert np.abs(g - r).max() <= TOL * np.abs(r).max()


def test_forward_outputs_match_tpudet(pair):
    kind, _, _, _, det, _, ref, got = pair
    assert type(det.model) is {'FasterRCNN': FasterRCNN, 'RPN': RPN,
                               'FastRCNN': FastRCNN}[kind]
    if kind == 'RPN':
        for g_lvls, r_lvls in zip(got, ref):
            for g, r in zip(g_lvls, r_lvls):
                _assert_maps_close(g, r)
        return
    props, valid, cls, deltas = got
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[1]))
    if kind == 'FasterRCNN':  # the proposals, scores aside
        zero = np.zeros(valid.shape)
        assert_one_to_one((props, zero, zero, valid),
                          (ref[0], zero, zero, ref[1]), 1e-4)
        assert int(valid.sum(1).min()) > 100
    else:  # the caller's
        np.testing.assert_array_equal(props.numpy(), np.asarray(ref[0]))
    _assert_maps_close(cls, ref[2])
    _assert_maps_close(deltas, ref[3])


def _to_torch(outputs):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), outputs)


@pytest.mark.parametrize('clip', [True, False])
def test_detections_match_tpudet(pair, clip):
    kind, _, jmodel, _, det, _, ref, got = pair
    kw, tkw = {}, {}
    if clip:
        sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
        hw = np.array([[IMG, IMG], [100, 90]], np.float32)
        kw = dict(scale_factors=jnp.asarray(sf),
                  img_shape=(jnp.asarray(hw[:, :1]), jnp.asarray(hw[:, 1:])))
        tkw = dict(scale_factors=_t(sf), img_shape=(_t(hw[:, :1]),
                                                    _t(hw[:, 1:])))
    rj = jmodel.get_bboxes(ref, **kw)
    same_input = det.model.get_bboxes(_to_torch(ref), **tkw)
    rt = det.model.get_bboxes(got, **tkw)
    if kind == 'RPN':  # proposals, label 0
        assert_proposals_equal(same_input[:2] + same_input[3:],
                               (rj[0], rj[1], rj[3]), score_atol=1e-5)
        assert_one_to_one(rt, rj, 1e-4)
        assert not rt.labels.any() and not same_input.labels.any()
        assert int(rt.valid.sum(1).min()) > 100
        return
    assert_detections_equal(same_input, rj)
    assert_one_to_one(rt, rj, 1e-3)
    assert int(rt.valid.sum(1).min()) >= 10


def test_detector_call_matches_tpudet(pair):
    """``Detector.__call__`` (forward, then ``get_bboxes`` rescaled, no
    ``img_shape``), as tpudet's ``Detector``."""
    kind, _, jmodel, _, det, args, ref, _ = pair
    if kind == 'FastRCNN':  # the caller supplies proposals: no Detector
        return
    sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
    rj = jmodel.get_bboxes(ref, scale_factors=jnp.asarray(sf))
    rt = det(np.array(args[0]), sf)
    assert_one_to_one(rt, rj, 1e-4 if kind == 'RPN' else 1e-3)


# the weights and the train state cross both ways

def _frcnn_tree(seed):
    model = build_detector(frcnn_cfg())
    return model, random_variables(jax.eval_shape(
        jax_build_detector(frcnn_cfg()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, IMG, IMG, 3))), seed)


def _assert_bytes_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_weights_round_trip_byte_equal():
    model, tree = _frcnn_tree(9)
    tree = jax.tree.map(np.asarray, tree)
    load_flax_variables(model, tree)
    back = state_dict_to_flax(model)
    _assert_bytes_equal(back, tree)
    head = tree['params']['roi_head']['bbox_head']
    # a Dense kernel is (in, out) in tpudet, (out, in) in the port; the
    # first FC reads the pooled (7, 7, 64) in HWC order with the same rows
    sd = flax_to_state_dict(tree, model)
    for name in ('shared_fc0', 'shared_fc1', 'fc_cls', 'fc_reg'):
        w = sd[f'roi_head.bbox_head.{name}.weight'].numpy()
        assert w.tobytes() == np.ascontiguousarray(
            head[name]['kernel'].T).tobytes(), name
    assert head['shared_fc0']['kernel'].shape == (7 * 7 * 64, 1024)


@pytest.mark.parametrize('opt_type', ['sgd', 'adam'])
def test_train_state_round_trip_byte_equal(opt_type):
    """A tpudet train state with its momentum (SGD) or stacked (m, v)
    (Adam) buffers: into the port and back, byte-equal; an Adam buffer of
    a Dense kernel is (2, in, out) in tpudet."""
    model, tree = _frcnn_tree(10)
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.RandomState(11)
    noise = lambda t, lead=(): jax.tree.map(  # noqa: E731
        lambda v: rng.randn(*lead, *v.shape).astype(np.float32), t)
    lead = (2,) if opt_type == 'adam' else ()
    flax_state = SimpleNamespace(
        step=np.asarray(7, np.int32), params=tree['params'],
        batch_stats=tree['batch_stats'], ema_params=noise(tree['params']),
        ema_batch_stats=jax.tree.map(np.abs, noise(tree['batch_stats'])),
        opt_state=SimpleNamespace(momentum_buf=noise(tree['params'], lead)))
    assert flax_state.opt_state.momentum_buf['roi_head']['bbox_head'][
        'fc_cls']['kernel'].shape == lead + (1024, NUM_CLASSES + 1)
    state = train_state_from_flax(flax_state, model,
                                  YoloSGDConfig(opt_type=opt_type))
    back = train_state_to_flax(state, model)
    assert int(back.step) == 7
    for name in ('params', 'batch_stats', 'ema_params', 'ema_batch_stats'):
        _assert_bytes_equal(getattr(back, name), getattr(flax_state, name))
    _assert_bytes_equal(back.opt_state.momentum_buf,
                        flax_state.opt_state.momentum_buf)
    buf = state.opt_state.momentum_buf['roi_head.bbox_head.fc_cls.weight']
    assert tuple(buf.shape) == lead + (NUM_CLASSES + 1, 1024)


def test_random_flax_variables_draws_each_dense_by_its_initializer():
    model = build_detector(frcnn_cfg())
    tree = random_flax_variables(model, seed=0)['params']
    head = tree['roi_head']['bbox_head']
    for name in ('shared_fc0', 'shared_fc1'):  # xavier_uniform
        fan_in, fan_out = head[name]['kernel'].shape
        limit = math.sqrt(6 / (fan_in + fan_out))
        k = np.abs(head[name]['kernel'])
        assert k.max() <= limit and k.max() > 0.99 * limit, name
    assert 0.0098 < head['fc_cls']['kernel'].std() < 0.0102
    assert 0.00098 < head['fc_reg']['kernel'].std() < 0.00102
    for name in ('rpn_conv', 'rpn_cls', 'rpn_reg'):
        std = tree['rpn_head'][name]['kernel'].std()
        assert 0.009 < std < 0.011, name
    for node in (head['shared_fc0'], head['fc_cls'], head['fc_reg'],
                 tree['rpn_head']['rpn_cls']):
        assert not node['bias'].any()


@pytest.mark.parametrize('kind', ['FasterRCNN', 'RPN', 'FastRCNN'])
def test_param_labels_equal_tpudets(kind):
    cfg = frcnn_cfg(kind)
    shapes = jax.eval_shape(jax_build_detector(cfg).init,
                            jax.random.PRNGKey(0),
                            *_jax_init_args(kind, np.zeros((2, 64, 64, 3),
                                                           np.float32)))
    ref = {}
    jax.tree_util.tree_map_with_path(
        lambda p, v: ref.__setitem__(tuple(k.key for k in p),
                                     param_group_label(p, v)),
        shapes['params'])
    model = build_detector(cfg)
    labels = param_labels(model)
    got = {path[1:]: labels[key] for path, (key, _) in
           leaf_table(model).items() if path[0] == 'params'}
    assert got == ref
