"""RepPoints (``RepPointsHead``, the point assigner, ``RepPointsDetector``)
in tpudet_torch against tpudet, on the CPU.

The detector is tpudet's test config (``tests/test_models/
test_reppoints.py``: ResNet-18, a 32-channel FPN from C3, one stacked
conv), 5 classes and the shipped config's caps, at 128 px, a batch of 2;
random weights for every leaf (``test_torch_fcos_family.py``'s
``random_variables`` of the leaves' shapes: N(0, 1 / fan-in) kernels, so
the init points sit strides off the grid and the deformable convs sample
between cells; ``moment_transfer`` N(0, 0.1^2), not tpudet's 0).

Tolerances:

- the point assigner's codes equal tpudet's, with the ties of a gt centre
  midway between two points (the lower point index) and of two gts at one
  distance from a point (the lower gt index);
- pred maps (logits, init and refined boxes) within 1e-4 of each map's
  largest |value|, fp32, eval mode;
- ``loss`` on tpudet's pred maps in float64 (the MaxIoU over the decoded
  init boxes and the nearest points are choices on computed values): each
  term rtol 1e-6, its gradient with respect to the maps rtol 1e-6, atol
  1e-9 of the largest |value|; gts in one image and none in the other;
  without any gt;
- ``get_bboxes`` of tpudet's maps: the keeps equal (boxes 1e-3 px, scores
  1e-5), clipped to per-image shapes and rescaled or not; end to end one
  to one;
- one train step in float64 on both sides, 2 images of 64 px, from the
  same random weights, at one level (P5 alone: XLA compiles tpudet's
  float64 deformable backward for seconds a site, 2 sites here), the
  deformable sites' and ``moment_transfer``'s gradients in it: the losses
  and gradient norm rtol 1e-4, the state within 5e-3 of the step's change
  (``test_torch_atss_gfl.py``).

The module tests run P3-P5 (6 deformable sites: tpudet's jitted forward
compiles for seconds a site); the point assigner's tests all five
levels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.dense_heads.reppoints_head import \
    RepPointsHead as JRepPointsHead
from tpudet_torch.core.assigners import point_assign_batch
from tpudet_torch.models.detectors.single_stage import RepPointsDetector

from .test_models.test_reppoints import reppoints_cfg
from .test_torch_atss_gfl import (assert_step_matches, float64_step, gts,
                                  step_batch)
from .test_torch_backbone_neck import random_variables
from .test_torch_fcos_family import (NUM_CLASSES, assert_get_bboxes_match,
                                     assert_maps_close, detector_pair,
                                     leaf_shapes, shipped)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KEYS = ('loss_cls', 'loss_pts_init', 'loss_pts_refine')
STRIDES = (8, 16, 32, 64, 128)


def cfg(levels=5):
    """The test config, or its top ``levels`` (P5, or P3-P5) without the
    extra levels."""
    c = shipped(reppoints_cfg(NUM_CLASSES))
    if levels != 5:
        c['backbone'] = dict(c['backbone'], out_indices=[1, 2, 3][-levels:])
        c['neck'] = dict(c['neck'], in_channels=[128, 256, 512][-levels:],
                         start_level=0, num_outs=levels,
                         add_extra_convs=False)
        c['bbox_head'] = dict(c['bbox_head'],
                              strides=(8, 16, 32)[-levels:])
    return c


@pytest.fixture(scope='module')
def pair():
    return detector_pair(cfg(3), 60)


def test_pred_maps_match_tpudet(pair):
    _, variables, det, _, ref, got = pair
    assert type(det.model) is RepPointsDetector
    assert float(np.abs(variables['params']['bbox_head'][
        'moment_transfer']).min()) > 0
    assert [tuple(c.shape[1:3]) for c in got[0]] == [(16, 16), (8, 8),
                                                     (4, 4)]
    assert got[1][0].shape == (2, 256, 4) and got[2][0].dtype == torch.float32
    # the init points reach strides off the grid: the boxes are not the
    # cell's regular 3x3 moment box
    widths = (got[1][0][..., 2] - got[1][0][..., 0]) / 8
    assert float(widths.std()) > 0.1
    assert_maps_close(got, ref)


def x64_loss(jmodel, model, ref, boxes, labels, valid):
    """``loss`` of both packages on tpudet's maps in float64; returns
    (port's losses, tpudet's, port's map grads, tpudet's)."""
    maps = jax.tree.map(lambda a: np.asarray(a, np.float64), ref)
    with jax.enable_x64(True):
        def total(preds):
            out = jmodel.loss(preds, jnp.asarray(boxes), jnp.asarray(labels),
                              jnp.asarray(valid))
            return sum(out[k] for k in KEYS), out
        (_, jl), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
            jax.tree.map(jnp.asarray, maps))
        jl, jg = jax.device_get((jl, jg))
    tmaps = jax.tree.map(lambda a: torch.tensor(a).requires_grad_(), maps)
    tl = model.loss(tmaps, *(torch.from_numpy(a)
                             for a in (boxes, labels, valid)))
    sum(tl[k] for k in KEYS).backward()
    tg = jax.tree.map(lambda t: np.zeros(t.shape) if t.grad is None
                      else t.grad.numpy(), tmaps)
    return tl, jl, tg, jg


@pytest.mark.parametrize('empty', [False, True])
def test_loss_and_gradients_match_tpudet_in_float64(pair, empty):
    jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(61)
    valid[:] = valid & (not empty)
    tl, jl, tg, jg = x64_loss(jmodel, det.model, ref, boxes, labels, valid)
    assert set(tl) == set(jl)
    for k in tl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-6, err_msg=k)
    for g, r in zip(jax.tree.leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(g, r, rtol=1e-6,
                                   atol=1e-9 * max(np.abs(r).max(), 1))
    if not empty:
        assert all(float(tl[k]) > 0 for k in KEYS)


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    _, _, det, _, ref, got = pair
    jmodel = pair[0]
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale, 0)


def drawn_step(config, seed, forward_train=False, adjust=None):
    """``float64_step`` from ``random_variables`` of the config's leaves
    (no trace of tpudet's ``init``, seconds a deformable site), the params
    passed through ``adjust`` where given."""
    variables = jax.tree.map(np.asarray, random_variables(
        leaf_shapes(config), seed))
    if adjust is not None:
        variables['params'] = adjust(variables['params'])
    return float64_step(config, step_batch(seed), forward_train,
                        variables=variables)


def test_a_train_step_matches_tpudet_in_float64():
    state0, jstate, jm, tstate, tm, _ = drawn_step(cfg(1), 62)
    assert_step_matches(state0, jstate, jm, tstate, tm, KEYS)
    head = state0.params['bbox_head']
    assert not np.array_equal(tstate.params['bbox_head']['moment_transfer'],
                              head['moment_transfer'])


# the point assigner

def point_grid(sizes, strides=STRIDES):
    jhead = JRepPointsHead(num_classes=2, strides=strides)
    pts, lvl, _ = jhead._points(sizes)
    return jhead, pts, lvl


def assign_both(sizes, boxes, valid, pos_num=1):
    jhead, pts, lvl = point_grid(sizes)
    jhead = jhead.clone(init_pos_num=pos_num)
    ref = np.stack([np.asarray(jhead._point_assign(
        jnp.asarray(pts), jnp.asarray(lvl), jnp.asarray(b), jnp.asarray(v)))
        for b, v in zip(boxes, valid)])
    got = point_assign_batch(
        torch.from_numpy(pts), torch.from_numpy(lvl.astype(np.int64)),
        torch.from_numpy(boxes), torch.from_numpy(valid), 3, 7, 4.0,
        pos_num).numpy()
    return got, ref


@pytest.mark.parametrize('pos_num', [1, 3])
def test_point_assigner_matches_tpudet(pos_num):
    boxes, _, valid = gts(63, size=128)
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    got, ref = assign_both(sizes, boxes, valid, pos_num)
    np.testing.assert_array_equal(got, ref)
    assert (got[0] >= 0).sum() >= pos_num * 3 and (got[1] < 0).all()


def test_point_assigner_ties_go_to_the_lower_index():
    """A 32-px gt centred between two stride-8 points (x = 60: the points
    56 and 64 tie) takes the lower; two gts at the same distance from
    their one nearest point (48, 40) leave it to the lower gt index."""
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    boxes = np.array([[[44., 40., 76., 72.],    # centre (60, 56)
                       [100., 40., 132., 72.],  # centre (116, 56)
                       [34., 24., 66., 56.],    # centre (50, 40)
                       [30., 24., 62., 56.]]], np.float32)  # (46, 40)
    valid = np.ones((1, 4), bool)
    got, ref = assign_both(sizes, boxes, valid)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 7 * 16 + 7] == 0 and got[0, 7 * 16 + 8] < 0
    assert got[0, 7 * 16 + 14] == 1
    assert got[0, 5 * 16 + 6] == 2 and (got[0] == 3).sum() == 0
