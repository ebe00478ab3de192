"""Head decode + lane-budgeted class-aware NMS: tpudet_torch against tpudet.

Synthetic pred maps at the full YOLOv4 640 shapes (B = 2, 80 classes),
from a numpy seed, go through both frameworks' ``get_bboxes`` at the
shipped ``test_cfg`` (anchor_pre 2048, lane_pre 4, class_pre 256, IoU
0.65, 300 per image, score_thr 0.001), on the CPU in fp32.

Tolerances: ``valid`` and ``labels`` equal; boxes atol 1e-4 (640-px
coordinates, a few fp32 ulp of the decode arithmetic); scores atol 1e-6
(sigmoid products in [0, 1]). The NMS units hold exactly.

The head's fields at 128 px, 4 classes: ``class_agnostic`` (objectness is
the score, no class term in the loss) and anchors and strides of its own
(2 levels of 2 anchors): bias priors equal; decode, ``get_bboxes``
(prefiltered and dense) at the tolerances above; the loss and its
gradients rtol 1e-5, as in ``test_torch_train_loss.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core import nms as jnms
from tpudet.models.dense_heads.yolocsp_head import YOLOCSPHead as JaxHead
from tpudet_torch.core import nms as tnms
from tpudet_torch.models.dense_heads.yolocsp_head import YOLOCSPHead

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

TEST_CFG = dict(score_thr=0.001, iou_thr=0.65, max_per_img=300, nms_pre=0,
                anchor_pre=2048, lane_pre=4, class_pre=256)
IN_CHANNELS = (256, 512, 1024)


def _pred_maps(seed, batch=2, img=640, num_classes=80):
    """Logits spread wide, quantized to 1/8 so that many scores tie
    exactly, and blocks of anchors copied elsewhere (same logits at
    another place)."""
    rng = np.random.RandomState(seed)
    attrib = 5 + num_classes
    maps = []
    for stride in (8, 16, 32):
        hw = img // stride
        p = rng.randn(batch, hw, hw, 3, attrib).astype(np.float32)
        p[..., :4] *= 1.5
        p[..., 4] = p[..., 4] * 3.0 - 2.0
        p[..., 5:] = p[..., 5:] * 3.0 - 3.0
        p = np.round(p * 8) / 8
        # tied copies: rows of the grid repeated further down
        p[:, hw // 2:hw // 2 + 2] = p[:, 1:3]
        maps.append(p.reshape(batch, hw, hw, 3 * attrib))
    return maps


def _heads(num_classes=80):
    return (JaxHead(num_classes=num_classes, in_channels=IN_CHANNELS),
            YOLOCSPHead(num_classes, IN_CHANNELS))


def _assert_same_dets(rj, rt):
    valid = np.asarray(rj.valid)
    np.testing.assert_array_equal(rt.valid.numpy(), valid)
    np.testing.assert_array_equal(rt.labels.numpy(), np.asarray(rj.labels))
    np.testing.assert_allclose(rt.bboxes.numpy(), np.asarray(rj.bboxes),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize('seed', [0, 1])
def test_get_bboxes_matches_tpudet_at_640(seed):
    maps = _pred_maps(seed)
    jhead, thead = _heads()
    rj = jhead.get_bboxes([jnp.asarray(m) for m in maps], **TEST_CFG)
    rt = thead.get_bboxes([torch.from_numpy(m) for m in maps], **TEST_CFG)
    assert int(np.asarray(rj.valid).sum()) > 100  # real NMS work
    _assert_same_dets(rj, rt)


def test_get_bboxes_rescale_and_dense_fallback():
    """scale_factors divide the boxes back; anchor_pre >= N decodes every
    anchor (tpudet's dense fallback)."""
    maps = _pred_maps(2, img=128, num_classes=4)
    jhead, thead = _heads(num_classes=4)
    sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
    cfg = dict(TEST_CFG, anchor_pre=4096)
    rj = jhead.get_bboxes([jnp.asarray(m) for m in maps],
                          scale_factors=jnp.asarray(sf), **cfg)
    rt = thead.get_bboxes([torch.from_numpy(m) for m in maps],
                          scale_factors=sf, **cfg)
    assert int(np.asarray(rj.valid).sum()) > 10
    _assert_same_dets(rj, rt)


def test_decode_matches_tpudet():
    maps = _pred_maps(3, img=128, num_classes=4)
    jhead, thead = _heads(num_classes=4)
    jb, jc, jk = jhead.decode_pred_maps([jnp.asarray(m) for m in maps])
    tb, tc, tk = thead.decode_pred_maps([torch.from_numpy(m) for m in maps])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6, rtol=0)


def test_topk_scores_breaks_ties_by_lowest_index():
    x = np.array([[1., 3., 3., 2., 3., 1., 2.]], np.float32)
    jv, ji = jnms.topk_scores(jnp.asarray(x), 5)
    tv, ti = tnms.topk_scores(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), [[1, 2, 4, 3, 6]])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _boxes(rng, n, spread=600., size=80.):
    xy = rng.rand(n, 2).astype(np.float32) * spread
    wh = rng.rand(n, 2).astype(np.float32) * size + 4
    return np.concatenate([xy, xy + wh], -1)


def _nms_pair(boxes, scores, iou, max_out, valid=None, block=512):
    jv = None if valid is None else jnp.asarray(valid)
    rj = jnms.nms_blocked(jnp.asarray(boxes), jnp.asarray(scores), iou,
                          max_out, valid=jv, block=block, return_dets=True)
    tv = None if valid is None else torch.from_numpy(valid)[None]
    rt = tnms.nms_blocked(torch.from_numpy(boxes)[None],
                          torch.from_numpy(scores)[None], iou, max_out,
                          valid=tv, block=block, return_dets=True)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(a))
    return rt


def test_nms_blocked_ties_keep_index_order():
    """Equal scores: the lower index ranks first, so it is the one kept
    of an overlapping pair."""
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 300, spread=200., size=60.)
    scores = (rng.randint(0, 6, 300) / 8.).astype(np.float32) + 0.1
    keep_valid = _nms_pair(boxes, scores, 0.5, 300, block=64)[3]
    assert 64 < int(keep_valid.sum()) < 300  # several blocks, suppression


def test_nms_blocked_all_padding():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 100)
    scores = rng.rand(100).astype(np.float32)
    res = _nms_pair(boxes, scores, 0.65, 50, valid=np.zeros(100, bool))
    assert not res[3].any()
    assert (res[2] == 0).all() and (res[1] == 0).all()


def test_nms_blocked_more_keeps_than_max_out():
    """Disjoint boxes all survive suppression: the walk stops at max_out,
    mid-block, keeping the top max_out by score."""
    n = 1500
    i = np.arange(n, dtype=np.float32)
    boxes = np.stack([i * 10, i * 0, i * 10 + 5, i * 0 + 5], -1)
    scores = np.random.RandomState(2).rand(n).astype(np.float32)
    res = _nms_pair(boxes, scores, 0.65, 300, block=256)
    assert bool(res[3].all())
    np.testing.assert_array_equal(res[2][0].numpy(),
                                  np.argsort(-scores, kind='stable')[:300])


@pytest.mark.parametrize('n,k_per_lane', [(512, 2), (300, 4)])
def test_lane_topk_select_first_occurrence_ties(n, k_per_lane):
    """Coarse scores tie within lanes: the first occurrence is picked
    first, and its own box comes with it."""
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, n)
    scores = (rng.randint(0, 4, (n, 5)) / 4.).astype(np.float32)
    valid = rng.rand(n) > 0.1
    sj, cj = jnms.lane_topk_select(jnp.asarray(boxes), jnp.asarray(scores),
                                   0.2, k_per_lane=k_per_lane,
                                   valid=jnp.asarray(valid))
    st, ct = tnms.lane_topk_select(torch.from_numpy(boxes)[None],
                                   torch.from_numpy(scores)[None], 0.2,
                                   k_per_lane=k_per_lane,
                                   valid=torch.from_numpy(valid)[None])
    np.testing.assert_array_equal(st[0].numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ct[0].numpy(), np.asarray(cj))


def test_class_lane_nms_single_image_matches_tpudet():
    rng = np.random.RandomState(4)
    boxes = _boxes(rng, 1000, spread=300.)
    scores = (rng.rand(1000, 6) ** 3).astype(np.float32)
    rj = jnms.class_lane_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.05,
                             0.5, 100, lane_pre=4, class_pre=64)
    rt = tnms.class_lane_nms(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.05, 0.5, 100,
                             lane_pre=4, class_pre=64)
    assert int(np.asarray(rj.valid).sum()) > 20
    _assert_same_dets(rj, rt)


# the head's fields: class_agnostic, and anchors and strides of its own

OWN_ANCHORS = dict(base_sizes=(((20, 30), (50, 40)), ((90, 120), (200, 160))),
                   featmap_strides=(16, 32))


def _field_maps(seed, strides=(8, 16, 32), anchors=3, attrib=5, batch=2,
                img=128):
    rng = np.random.RandomState(seed)
    maps = []
    for stride in strides:
        hw = img // stride
        p = rng.randn(batch, hw, hw, anchors, attrib).astype(np.float32)
        p[..., :4] *= 1.5
        p[..., 4:] = p[..., 4:] * 3.0 - 1.0
        maps.append(p.reshape(batch, hw, hw, anchors * attrib))
    return maps


FIELD_CASES = {
    'class_agnostic': (dict(class_agnostic=True), dict(attrib=5)),
    'own_anchors': (OWN_ANCHORS, dict(strides=(16, 32), anchors=2,
                                      attrib=9)),
}


def _field_heads(kw):
    in_channels = [8] * len(kw.get('featmap_strides', (8, 16, 32)))
    return (JaxHead(num_classes=4, in_channels=in_channels, **kw),
            YOLOCSPHead(4, in_channels, **kw))


@pytest.mark.parametrize('case', list(FIELD_CASES))
def test_head_fields_decode_and_get_bboxes_match_tpudet(case):
    kw, shape = FIELD_CASES[case]
    jhead, thead = _field_heads(kw)
    assert thead.num_attrib == shape['attrib']
    for lvl in range(thead.num_levels):
        n = len(thead.base_sizes[lvl]) * thead.num_attrib
        np.testing.assert_array_equal(
            thead.bias_prior(lvl), np.asarray(jhead._bias_init(lvl)(None,
                                                                    (n,))))
    maps = _field_maps(20, **shape)
    jb, jc, jk = jhead.decode_pred_maps([jnp.asarray(m) for m in maps])
    tb, tc, tk = thead.decode_pred_maps([torch.from_numpy(m) for m in maps])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    assert (tk is None) == (jk is None) == (case == 'class_agnostic')
    for anchor_pre in (64, 0):  # the prefiltered and the dense decode
        cfg = dict(TEST_CFG, anchor_pre=anchor_pre, max_per_img=50)
        rj = jhead.get_bboxes([jnp.asarray(m) for m in maps], **cfg)
        rt = thead.get_bboxes([torch.from_numpy(m) for m in maps], **cfg)
        assert int(np.asarray(rj.valid).sum()) > 10
        _assert_same_dets(rj, rt)
    if case == 'class_agnostic':
        assert not rt.labels.any()


def _gts(seed, batch=2, g_max=5, size=128):
    rng = np.random.RandomState(seed)
    wh = rng.uniform(6, size * 0.7, (batch, g_max, 2))
    c = rng.uniform(0, size, (batch, g_max, 2))
    gt = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0,
                 size).astype(np.float32)
    valid = rng.rand(batch, g_max) < 0.8
    valid[:, 0] = True
    return gt, rng.randint(0, 4, (batch, g_max)).astype(np.int32), valid


@pytest.mark.parametrize('case', list(FIELD_CASES))
def test_head_fields_loss_matches_tpudet(case):
    import jax
    kw, shape = FIELD_CASES[case]
    jhead, thead = _field_heads(kw)
    maps = _field_maps(21, **shape)
    gt, labels, valid = _gts(22)
    keys = ('loss_cls', 'loss_conf', 'loss_bbox')

    def jax_total(maps_):
        out = jhead.loss(tuple(maps_), jnp.asarray(gt), jnp.asarray(labels),
                         jnp.asarray(valid))
        return sum(out[k] for k in keys), out

    (_, ref), ref_grads = jax.value_and_grad(jax_total, has_aux=True)(
        [jnp.asarray(m) for m in maps])
    tmaps = [torch.from_numpy(m).requires_grad_() for m in maps]
    got = thead.loss(tmaps, torch.from_numpy(gt), torch.from_numpy(labels),
                     torch.from_numpy(valid))
    sum(got[k] for k in keys).backward()
    for k in keys + ('num_gts',):
        assert torch.is_tensor(got[k])
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]),
                                   rtol=1e-5, err_msg=k)
    assert (float(got['loss_cls'].detach()) == 0) == (
        case == 'class_agnostic')
    for t, r in zip(tmaps, ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r,
                                   atol=1e-5 * np.abs(r).max(), rtol=1e-5)
