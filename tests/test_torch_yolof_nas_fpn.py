"""YOLOF (the uniform matching, ``DeltaXYWHBBoxCoder(add_ctr_clamp=True)``,
``DilatedEncoder``, ``YOLOFHead``), ``ChannelMapper`` and the NAS-FPN
RetinaNet (``NASFPN``, ``RetinaSepBNHead``) in tpudet_torch against
tpudet, on the CPU.

- ``uniform_assign_batch`` and ``uniform_match_pairs_batch``: the codes
  and the pairs equal tpudet's index for index, on random gts, on gts
  whose centres sit midway between anchor centres and that repeat (their
  L1 costs tie across the top-k: ties to the lower index, as
  ``lax.top_k``), and on an image without a gt;
- the clamped decode: equal to tpudet's within 1e-6 relative, 1e-4 px,
  with deltas that reach the centre clamp (32 px) and the width clamp;
- the necks (``ChannelMapper`` with and without BN, ``DilatedEncoder``,
  ``NASFPN`` with 2 stacks) on the same weights, eval and train mode (BN
  on the batch's statistics; the running statistics after the call too):
  within 1e-5 of each output's largest |value|; NAS-FPN's sizes that are
  not integer ratios raise in both packages (tpudet asserts);
- the detectors: tpudet's YOLOF test config (ResNet-18, a 64-channel
  encoder of 2 blocks) and a narrow NAS-FPN RetinaNet (ResNet-18, 32
  channels, 2 stacks, one stacked conv), 5 classes and the shipped caps,
  at 128 px, batches of 2, with ``test_torch_fcos_family.py``'s helpers
  and tolerances (pred maps, the loss terms and their gradients on
  tpudet's maps, ``get_bboxes``, one float64 step from tpudet's init).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core import assigners as jassign
from tpudet.core import bbox as jbbox
from tpudet.models.builder import build_neck as jax_build_neck
from tpudet_torch.core import assigners as tassign
from tpudet_torch.core import bbox as tbbox
from tpudet_torch.models.builder import _build
from tpudet_torch.models.detectors.single_stage import YOLOF, RetinaNet
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_models.test_yolof import yolof_cfg
from .test_torch_atss_gfl import (assert_step_matches, float64_step, gts,
                                  step_batch)
from .test_torch_backbone_neck import _max_rel, random_variables
from .test_torch_fcos_family import (NUM_CLASSES, assert_get_bboxes_match,
                                     assert_loss_and_map_gradients,
                                     assert_maps_close, detector_pair,
                                     shipped)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)


def nas_fpn_cfg(num_classes=NUM_CLASSES):
    """The shipped NAS-FPN RetinaNet narrowed: ResNet-18, 32 channels, 2
    stacks, one stacked conv (the levels at strides 4-64, as the shipped
    config's ``start_level`` 0 gives them)."""
    return dict(
        type='RetinaNet',
        backbone=dict(type='ResNet', depth=18, out_indices=[0, 1, 2, 3]),
        neck=dict(type='NASFPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, stack_times=2, num_outs=5),
        bbox_head=dict(type='RetinaSepBNHead', num_classes=num_classes,
                       num_ins=5, in_channels=32, feat_channels=32,
                       stacked_convs=1))


MODELS = {
    'yolof': (lambda: shipped(yolof_cfg(NUM_CLASSES), 0.6), YOLOF,
              ('loss_cls', 'loss_bbox'), 0),
    'nas_fpn': (lambda: shipped(nas_fpn_cfg()), RetinaNet,
                ('loss_cls', 'loss_bbox'), 1),
}


@pytest.fixture(scope='module', params=list(MODELS))
def pair(request):
    return (request.param,) + detector_pair(MODELS[request.param][0](), 60)


def test_pred_maps_match_tpudet(pair):
    kind, _, _, det, _, ref, got = pair
    assert type(det.model) is MODELS[kind][1]
    sizes = [tuple(c.shape[1:3]) for c in got[0]]
    assert sizes == ([(4, 4)] if kind == 'yolof' else
                     [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)])
    assert_maps_close(got, ref)


def test_loss_and_gradients_match_tpudet(pair):
    kind, jmodel, _, det, _, ref, _ = pair
    keys = MODELS[kind][2]
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, *gts(61),
                                       keys)
    assert all(float(tl[k]) > 0 for k in keys)


def test_loss_without_gts_matches_tpudet(pair):
    kind, jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(62)
    valid[:] = False
    assert_loss_and_map_gradients(jmodel, det.model, ref, boxes, labels,
                                  valid, MODELS[kind][2][:1])


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    kind, jmodel, _, det, _, ref, got = pair
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale,
                            MODELS[kind][3])


@pytest.mark.parametrize('kind', list(MODELS))
def test_a_train_step_matches_tpudet_in_float64(kind):
    state0, jstate, jm, tstate, tm, _ = float64_step(MODELS[kind][0](),
                                                     step_batch(63))
    assert_step_matches(state0, jstate, jm, tstate, tm, MODELS[kind][2])


# the uniform matching

def _uniform_case(case):
    """(pred boxes (B, A, 4), anchors (A, 4), gts (B, G, 4), valid)."""
    rng = np.random.RandomState({'random': 0, 'ties': 1}[case])
    stride, n = 32, 5  # a 5 x 5 grid of YOLOF's five square anchors
    xs = (np.arange(n) + 0.5) * stride
    ctr = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 1, 2)
    half = np.array([1, 2, 4, 8, 16])[None, :, None] * stride / 2.
    anchors = np.concatenate([ctr - half, ctr + half], -1).reshape(-1, 4)
    b, g = 3, 6
    if case == 'ties':
        # centres midway between anchor centres (multiples of 32), sides
        # midway between two anchor sizes, repeated gts: the L1 costs of 8
        # anchors a gt tie
        c = rng.randint(1, n, (b, g, 2)) * stride * 1.0
        wh = np.full((b, g, 2), 48.)
        c[:, 1], wh[:, 1] = c[:, 0], wh[:, 0]
    else:
        wh = rng.uniform(20, 120, (b, g, 2))
        c = rng.uniform(wh / 2, n * stride - wh / 2)
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1)
    pred = anchors[None] + rng.randn(b, len(anchors), 4) * 8
    if case == 'ties':
        pred = np.repeat(anchors[None], b, 0)  # the predictions tie too
    valid = rng.rand(b, g) < 0.8
    valid[:, :2] = True
    valid[2] = False  # an image without a gt
    return tuple(a.astype(np.float32) if a.dtype != bool else a
                 for a in (pred, anchors, gt, valid))


@pytest.mark.parametrize('case', ['random', 'ties'])
def test_uniform_assigner_and_pairs_equal_tpudets(case):
    args = _uniform_case(case)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    ref = np.asarray(jassign.uniform_assign_batch(*jargs, 4, 0.15, 0.7))
    got = tassign.uniform_assign_batch(*targs, 4, 0.15, 0.7)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[:2] >= 0).sum() > 4 and (ref[2] == -1).all()
    ref_pairs = jassign.uniform_match_pairs_batch(*jargs, 4, 0.15)
    got_pairs = tassign.uniform_match_pairs_batch(*targs, 4, 0.15)
    for g, r in zip(got_pairs, ref_pairs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if case == 'ties':
        # the top-4 of a gt's anchor costs cut through a tie
        gt_c = np.asarray(jbbox.bbox_cxcywh(jnp.asarray(args[2])))
        an_c = np.asarray(jbbox.bbox_cxcywh(jnp.asarray(args[1])))
        cost = np.abs(an_c[None, :, None] - gt_c[:, None]).sum(-1)
        srt = np.sort(cost[:2].transpose(0, 2, 1), -1)
        assert (srt[..., 3] == srt[..., 4]).any()


def test_ctr_clamped_decode_matches_tpudet():
    rng = np.random.RandomState(11)
    xy = rng.uniform(0, 200, (2, 50, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(8, 300, (2, 50, 2))],
                             -1).astype(np.float32)
    deltas = (rng.randn(2, 50, 4) * 2).astype(np.float32)
    deltas[:, :5, 2:] = 6.0  # past log(1000 / 16)
    deltas[:, 5:10, 2:] = -8.0  # below it: only the top is clamped
    jc = jbbox.DeltaXYWHBBoxCoder(add_ctr_clamp=True, ctr_clamp=32)
    tc = tbbox.DeltaXYWHBBoxCoder(add_ctr_clamp=True, ctr_clamp=32)
    hw = np.array([[300.], [250.]], np.float32)
    for shape in (None, (hw, hw + 20)):
        ref = jc.decode(jnp.asarray(anchors), jnp.asarray(deltas),
                        max_shape=None if shape is None else tuple(
                            jnp.asarray(s) for s in shape))
        got = tc.decode(torch.from_numpy(anchors), torch.from_numpy(deltas),
                        max_shape=None if shape is None else tuple(
                            torch.from_numpy(s) for s in shape))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-4)
    ctr = (anchors[..., :2] + anchors[..., 2:]) / 2
    moved = np.abs((got.numpy()[..., :2] + got.numpy()[..., 2:]) / 2 - ctr)
    assert moved.max() > 31.9  # the clamp was reached


# the necks

def _feats(channels, base, seed, b=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, base >> i, base >> i, c).astype(np.float32)
            for i, c in enumerate(channels)]


NECKS = {
    'channel_mapper': (dict(type='ChannelMapper', in_channels=[8, 16, 32],
                            out_channels=24, num_outs=5), [8, 16, 32], 32),
    'channel_mapper_bn': (dict(type='ChannelMapper', in_channels=[8, 16, 32],
                               out_channels=24, num_outs=4, use_norm=True,
                               kernel_size=1), [8, 16, 32], 32),
    'dilated_encoder': (dict(type='DilatedEncoder', in_channels=32,
                             out_channels=16, block_mid_channels=8,
                             num_residual_blocks=4), [8, 16, 32], 32),
    'nas_fpn': (dict(type='NASFPN', in_channels=[8, 16, 32],
                     out_channels=8, num_outs=5, stack_times=2),
                [8, 16, 32], 32),
}


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('name', list(NECKS))
def test_neck_matches_tpudet(name, train):
    cfg, channels, base = NECKS[name]
    x = _feats(channels, base, 12)
    jneck = jax_build_neck(dict(cfg))
    jx = tuple(jnp.asarray(a) for a in x)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jneck.init, jax.random.PRNGKey(0), jx), 13))
    if train:
        ref, mutated = jneck.apply(variables, jx, True,
                                   mutable=['batch_stats'])
    else:
        ref = jneck.apply(variables, jx)
    neck = load_flax_variables(_build(dict(cfg)), variables)
    neck.train(train)
    with torch.no_grad():
        got = neck([torch.from_numpy(a).permute(0, 3, 1, 2) for a in x])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape
        assert _max_rel(g, np.asarray(r)) <= 1e-5
    if train and 'batch_stats' in variables:
        sd = neck.state_dict()
        flat = jax.tree_util.tree_flatten_with_path(mutated['batch_stats'])[0]
        for path, v in flat:
            keys = [p.key for p in path]
            stat = 'running_mean' if keys[-1] == 'mean' else 'running_var'
            got_stat = sd['.'.join(keys[:-1] + [stat])].numpy()
            np.testing.assert_allclose(got_stat, np.asarray(v), rtol=1e-5,
                                       atol=1e-6)


def test_nas_fpn_refuses_sizes_that_are_not_integer_ratios():
    """Levels of 100 x 168, 50 x 84, 25 x 42: the floor pools make P6 12
    high, and 12 -> 50 is no integer ratio (the shipped config on a 1344
    x 800 canvas meets the same: P5 50 high, P7 12)."""
    cfg = dict(NECKS['nas_fpn'][0])
    channels = NECKS['nas_fpn'][1]
    x = [np.zeros((1, 100 >> i, 168 >> i, c), np.float32)
         for i, c in enumerate(channels)]
    jneck = jax_build_neck(dict(cfg))
    with pytest.raises(AssertionError):
        jax.eval_shape(jneck.init, jax.random.PRNGKey(0),
                       tuple(jnp.asarray(a) for a in x))
    with torch.device('meta'):
        neck = _build(dict(cfg))
        with pytest.raises(ValueError, match='integer ratio'):
            neck([torch.zeros(a.shape).permute(0, 3, 1, 2) for a in x])
