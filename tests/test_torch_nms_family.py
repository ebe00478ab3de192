"""The rest of ``tpudet/core/nms.py``: tpudet_torch against tpudet, on the
CPU in fp32.

``nms_padded`` (at K on either side of tpudet's 1,536-candidate switch
from its K x K form to its blocked walk; the port walks blocks at every
K), ``soft_nms_padded`` (linear and gaussian), ``nms``,
``multiclass_nms``/``batched_nms`` (hard and soft, the ``nms_pre`` cap
below and above 1536), ``dense_class_nms``/``batched_dense_class_nms``
and ``class_sorted_nms``/``batched_class_sorted_nms``, on boxes and
scores from numpy seeds (scores quantized so that many tie exactly),
tpudet's single-image functions under ``jax.vmap`` where it has no
batched form. Then every branch of ``YOLOCSPHead.get_bboxes`` against
tpudet's.

Tolerances: keep indices, ``valid`` and labels equal; scores within 1e-6;
boxes within 1e-4 (offset and un-offset coordinates of a few hundred
px, as in ``test_torch_head_nms.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core import nms as jnms
from tpudet.models.dense_heads.yolocsp_head import YOLOCSPHead as JaxHead
from tpudet_torch.core import nms as tnms
from tpudet_torch.models.dense_heads.yolocsp_head import YOLOCSPHead

from .test_torch_head_nms import _pred_maps

SCORE_ATOL, BOX_ATOL = 1e-6, 1e-4


def _boxes(rng, shape, spread=300., size=60.):
    xy = rng.rand(*shape, 2).astype(np.float32) * spread
    wh = rng.rand(*shape, 2).astype(np.float32) * size + 2
    return np.concatenate([xy, xy + wh], -1)


def _case(seed, b, k, levels=16):
    """(B, K) crowded boxes, scores quantized to ``levels`` values (ties),
    a valid mask with ~10 % padding."""
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, (b, k), spread=100.)
    scores = (rng.randint(1, levels + 1, (b, k)) / levels).astype(np.float32)
    valid = rng.rand(b, k) > 0.1
    return boxes, scores, valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_dets(rj, rt, box_atol=BOX_ATOL):
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_array_equal(rt.labels.numpy(), np.asarray(rj.labels))
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores),
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(rt.bboxes.numpy(), np.asarray(rj.bboxes),
                               atol=box_atol, rtol=0)


def _assert_same_keeps(got, ref):
    """Equal ``keep_valid``, and equal ``keep_idx`` in the valid slots.
    tpudet leaves a slot past the last keep unspecified (its K x K form
    fills it with a suppressed candidate, its blocked walk with 0); the
    port's are 0."""
    (gi, gv), (ri, rv) = got, ref
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gi.numpy()[gv.numpy()],
                                  np.asarray(ri)[np.asarray(rv)])
    assert not bool(gi[~gv].any())


@pytest.mark.parametrize('k', [600, 2000])
def test_nms_padded_matches_tpudet_below_and_above_the_blocked_size(k):
    boxes, scores, valid = _case(0, 2, k)
    ref = jax.vmap(lambda b, s, v: jnms.nms_padded(b, s, 0.5, 600, v))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = tnms.nms_padded(*_t(boxes, scores), 0.5, 600,
                          torch.from_numpy(valid))
    _assert_same_keeps(got, ref)
    assert 50 < int(got[1].sum()) < int(valid.sum())  # suppression


def test_nms_padded_pads_past_k_and_takes_no_mask():
    boxes, scores, _ = _case(1, 2, 40)
    ref = jax.vmap(lambda b, s: jnms.nms_padded(b, s, 0.3, 64))(
        jnp.asarray(boxes), jnp.asarray(scores))
    got = tnms.nms_padded(*_t(boxes, scores), 0.3, 64)
    _assert_same_keeps(got, ref)
    assert not bool(got[1][:, 40:].any())


def test_nms_gathers_the_kept_detections():
    boxes, scores, valid = _case(2, 2, 500)
    ref = jax.vmap(lambda b, s, v: jnms.nms(b, s, 0.45, 100, v))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = tnms.nms(*_t(boxes, scores), 0.45, 100, torch.from_numpy(valid))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('method', ['linear', 'gaussian'])
@pytest.mark.parametrize('k', [300, 2000])
def test_soft_nms_padded_matches_tpudet(method, k):
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, (2, k), spread=200.)
    scores = rng.rand(2, k).astype(np.float32)
    valid = rng.rand(2, k) > 0.1
    ref = jax.vmap(lambda b, s, v: jnms.soft_nms_padded(
        b, s, 0.3, 100, v, sigma=0.5, min_score=0.05, method=method))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = tnms.soft_nms_padded(*_t(boxes, scores), 0.3, 100,
                               torch.from_numpy(valid), sigma=0.5,
                               min_score=0.05, method=method)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=SCORE_ATOL, rtol=0)
    assert bool(got[2].all())  # 100 picks above min_score


def test_soft_nms_ties_pick_the_first_and_stop_at_min_score():
    """Equal scores: the lowest index is picked first; picks below
    ``min_score`` are not valid."""
    boxes = np.tile(np.array([[0, 0, 10, 10]], np.float32), (1, 6, 1))
    boxes[0, 3:] += 100
    scores = np.array([[0.5, 0.5, 0.5, 0.02, 0.5, 0.5]], np.float32)
    ref = jnms.soft_nms_padded(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                               0.3, 6, min_score=0.1)
    got = tnms.soft_nms_padded(*_t(boxes, scores), 0.3, 6, min_score=0.1)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    # 0 first of the tie, zeroing its copies 1 and 2; then 4, zeroing 3
    # and 5; then the first zero, not valid (what follows repeats picks of
    # score 0, as in tpudet)
    assert got[0][0, :3].tolist() == [0, 4, 1]
    assert got[2][0].tolist() == [True, True, False, False, False, False]


def _dense(seed, b=2, n=700, c=6):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, (b, n), spread=250.)
    scores = (np.round(rng.rand(b, n, c) ** 3 * 32) / 32).astype(np.float32)
    valid = rng.rand(b, n) > 0.05
    return boxes, scores, valid


@pytest.mark.parametrize('nms_type,nms_pre', [
    ('nms', 1000), ('nms', 4096), ('soft_nms', 1000), ('soft_nms', 4096)])
def test_batched_nms_matches_tpudet(nms_type, nms_pre):
    boxes, scores, valid = _dense(4)
    kw = dict(nms_pre=nms_pre, nms_type=nms_type, sigma=0.5, min_score=0.05,
              method='linear')
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.05,
                           0.5, 100, valid=jnp.asarray(valid), **kw)
    got = tnms.batched_nms(*_t(boxes, scores), 0.05, 0.5, 100,
                           valid=torch.from_numpy(valid), **kw)
    _assert_dets(ref, got)
    assert int(got.valid.sum()) > 100


def test_multiclass_nms_one_image_gaussian():
    boxes, scores, _ = _dense(5, b=1)
    ref = jnms.multiclass_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                              0.05, 0.5, 80, nms_pre=3000,
                              nms_type='soft_nms', method='gaussian')
    got = tnms.multiclass_nms(*_t(boxes[0], scores[0]), 0.05, 0.5, 80,
                              nms_pre=3000, nms_type='soft_nms',
                              method='gaussian')
    _assert_dets(ref, got)


@pytest.mark.parametrize('masked', [False, True])
def test_batched_dense_class_nms_matches_tpudet(masked):
    boxes, scores, valid = _dense(6)
    jv = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    ref = jnms.batched_dense_class_nms(jnp.asarray(boxes),
                                       jnp.asarray(scores), 0.05, 0.5, 100,
                                       valid=jv)
    got = tnms.batched_dense_class_nms(*_t(boxes, scores), 0.05, 0.5, 100,
                                       valid=tv)
    _assert_dets(ref, got)
    assert int(got.valid.sum()) == 200  # the cap binds


@pytest.mark.parametrize('class_pre', [32, 4096])
def test_batched_class_sorted_nms_matches_tpudet(class_pre):
    boxes, scores, valid = _dense(7)
    ref = jnms.batched_class_sorted_nms(
        jnp.asarray(boxes), jnp.asarray(scores), 0.05, 0.5, 100,
        class_pre=class_pre, valid=jnp.asarray(valid))
    got = tnms.batched_class_sorted_nms(
        *_t(boxes, scores), 0.05, 0.5, 100, class_pre=class_pre,
        valid=torch.from_numpy(valid))
    _assert_dets(ref, got)


def test_single_image_forms_match_tpudet():
    boxes, scores, valid = _dense(8, b=1)
    jb, js, jv = (jnp.asarray(x[0]) for x in (boxes, scores, valid))
    tb, ts, tv = _t(boxes[0], scores[0], valid[0])
    _assert_dets(jnms.dense_class_nms(jb, js, 0.05, 0.5, 50, valid=jv),
                 tnms.dense_class_nms(tb, ts, 0.05, 0.5, 50, valid=tv))
    _assert_dets(jnms.class_sorted_nms(jb, js, 0.05, 0.5, 50, class_pre=64,
                                       valid=jv),
                 tnms.class_sorted_nms(tb, ts, 0.05, 0.5, 50, class_pre=64,
                                       valid=tv))


# every branch of YOLOCSPHead.get_bboxes (tpudet yolocsp_head.py:233-262)

BRANCHES = {
    'class_sorted': dict(lane_pre=0, class_pre=64, nms_pre=2048),
    'dense_exact': dict(lane_pre=0, class_pre=0, nms_pre=0),
    'flat_nms_pre': dict(lane_pre=0, class_pre=0, nms_pre=1000),
    'soft_nms': dict(lane_pre=4, class_pre=0, nms_pre=-1,
                     nms_type='soft_nms', sigma=0.5, min_score=0.05,
                     method='gaussian'),
    # every anchor decoded, no objectness prefilter
    'class_sorted_dense_decode': dict(lane_pre=0, class_pre=64, nms_pre=2048,
                                      anchor_pre=0),
    'soft_nms_linear': dict(lane_pre=0, class_pre=0, nms_pre=500,
                            nms_type='soft_nms', min_score=0.05,
                            method='linear'),
}


@pytest.mark.parametrize('branch', list(BRANCHES))
def test_yolocsp_get_bboxes_branch_matches_tpudet(branch):
    maps = _pred_maps(9, img=128, num_classes=4)
    jhead = JaxHead(num_classes=4, in_channels=(8, 8, 8))
    thead = YOLOCSPHead(4, (8, 8, 8))
    cfg = dict(dict(score_thr=0.01, iou_thr=0.6, max_per_img=100,
                    anchor_pre=256), **BRANCHES[branch])
    rj = jhead.get_bboxes([jnp.asarray(m) for m in maps], **cfg)
    rt = thead.get_bboxes([torch.from_numpy(m) for m in maps], **cfg)
    assert int(np.asarray(rj.valid).sum()) > 50
    _assert_dets(rj, rt)
