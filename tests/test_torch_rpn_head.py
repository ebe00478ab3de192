"""The port's ``RPNHead`` and ``bce_loss`` against tpudet's, on the CPU in
fp32, from numpy seeds (16 channels, 5 FPN levels of a 128 px batch of
2, random kernels N(0, 1/fan_in), biases N(0, 0.1^2)).

Tolerances:

- ``bce_loss`` (with ``weight`` and ``avg_factor``) and its gradient:
  rtol 1e-5;
- the forward: atol 1e-5;
- ``loss`` (the fixed ``RandomState(0)`` sample priority, ties by index)
  and its gradients with respect to the pred maps: rtol 1e-5;
- ``get_proposals`` at the test settings (top 1000 a level), the train
  settings (top 2000), a binding NMS (top 100 a level, 50 kept) and with
  ``min_bbox_size > 0``, with and without ``img_shape``: the kept
  indices (which candidate, in which slot) and ``valid`` equal, boxes
  atol 1e-4 px, scores atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models import losses as jlosses
from tpudet.models.dense_heads.rpn_head import RPNHead as JaxRPNHead
from tpudet_torch.models import losses as tlosses
from tpudet_torch.models.dense_heads.rpn_head import RPNHead
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_backbone_neck import random_variables

IMG, CH = 128, 16
STRIDES = (4, 8, 16, 32, 64)


def _feats(seed, b=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, IMG // s, IMG // s, CH).astype(np.float32)
            for s in STRIDES]


def gts(seed, b=2, g=6, size=IMG, num_classes=3):
    """Padded gts: 6 in the first image, 2 in the second (sides 6-75 % of
    the image, so they match anchors of every level)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate((g, 2, 0)[:b]):
        wh = rng.uniform(0.06, 0.75, (n, 2)) * size
        xy = rng.uniform(0, 1, (n, 2)) * (size - wh)
        boxes[i, :n] = np.concatenate([xy, xy + wh], -1)
        valid[i, :n] = True
    labels = rng.randint(0, num_classes, (b, g)).astype(np.int32)
    return boxes, labels, valid


@pytest.fixture(scope='module')
def rpn_pair():
    jhead = JaxRPNHead(in_channels=CH, feat_channels=CH)
    feats = _feats(0)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0),
                            tuple(jnp.asarray(f) for f in feats))
    variables = random_variables(shapes, 1)
    head = RPNHead(in_channels=CH, feat_channels=CH)
    load_flax_variables(head, variables)
    ref = jhead.apply(variables, tuple(jnp.asarray(f) for f in feats))
    with torch.no_grad():
        got = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    return jhead, head, ref, got


def test_bce_loss_and_gradient_match_tpudet():
    rng = np.random.RandomState(2)
    pred = rng.randn(3, 50).astype(np.float32) * 4
    target = (rng.rand(3, 50) > 0.7).astype(np.float32)
    weight = (rng.rand(3, 50) > 0.4).astype(np.float32)
    for kw in (dict(), dict(weight=weight), dict(weight=weight,
                                                 avg_factor=17.0)):
        ref, jg = jax.value_and_grad(lambda p: jlosses.bce_loss(
            p, target, **kw))(jnp.asarray(pred))
        tp = torch.tensor(pred, requires_grad=True)
        got = tlosses.bce_loss(tp, torch.from_numpy(target),
                               **{k: torch.as_tensor(v)
                                  for k, v in kw.items()})
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref),
                                   rtol=1e-5)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-9)


def test_forward_matches_tpudet(rpn_pair):
    _, _, ref, got = rpn_pair
    for g_lvls, r_lvls in zip(got, ref):
        assert len(g_lvls) == 5
        for g, r in zip(g_lvls, r_lvls):
            assert tuple(g.shape) == np.asarray(r).shape
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_loss_and_gradients_match_tpudet(rpn_pair):
    jhead, head, ref, _ = rpn_pair
    boxes, labels, valid = gts(3)
    keys = ('loss_rpn_cls', 'loss_rpn_bbox')

    def jax_total(preds):
        out = jhead.loss(preds, jnp.asarray(boxes), jnp.asarray(labels),
                         jnp.asarray(valid))
        return sum(out[k] for k in keys), out

    (_, jl), jg = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, ref))
    tpreds = tuple(tuple(torch.tensor(np.asarray(r)).requires_grad_()
                         for r in lvls) for lvls in ref)
    tl = head.loss(tpreds, torch.from_numpy(boxes), torch.from_numpy(labels),
                   torch.from_numpy(valid))
    sum(tl[k] for k in keys).backward()
    assert set(tl) == set(jl)
    for k in keys:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(tl['loss_rpn_bbox'].detach()) > 0
    for t_lvls, r_lvls in zip(tpreds, jg):
        for t, r in zip(t_lvls, r_lvls):
            r = np.asarray(r)
            np.testing.assert_allclose(t.grad.numpy(), r,
                                       atol=1e-5 * np.abs(r).max(),
                                       rtol=1e-5)


PROPOSAL_CASES = {
    'test': dict(nms_pre=1000, max_num=1000, iou_thr=0.7),
    'train': dict(nms_pre=2000, max_num=1000, iou_thr=0.7),
    'binding': dict(nms_pre=100, max_num=50, iou_thr=0.5),
    'min_size': dict(nms_pre=300, max_num=200, iou_thr=0.7,
                     min_bbox_size=24.0),
}


def assert_proposals_equal(got, ref, box_atol=1e-4, score_atol=1e-6):
    """Equal keeps: the same candidate in each valid slot, so the same
    boxes to ``box_atol`` px and scores to ``score_atol``."""
    gp, gs, gv = (t.numpy() for t in got)
    rp, rs, rv = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_allclose(gs, rs, atol=score_atol)
    np.testing.assert_allclose(gp, rp, atol=box_atol)
    assert not gp[~gv].any()


@pytest.mark.parametrize('case', list(PROPOSAL_CASES))
@pytest.mark.parametrize('clip', [True, False])
def test_get_proposals_match_tpudet(rpn_pair, case, clip):
    jhead, head, ref, _ = rpn_pair
    kw = dict(PROPOSAL_CASES[case], img_shape=(IMG, IMG) if clip else None)
    rj = jhead.get_proposals(jax.tree.map(jnp.asarray, ref), **kw)
    rt = head.get_proposals(tuple(tuple(torch.tensor(np.asarray(r))
                                        for r in lvls) for lvls in ref),
                            **kw)
    assert_proposals_equal(rt, rj)
    n_valid = rt[2].sum(1)
    assert int(n_valid.min()) > 0
    if case == 'binding':
        assert int(n_valid.min()) == 50
    if case == 'min_size':
        p = rt[0][rt[2]]
        assert float(torch.minimum(p[:, 2] - p[:, 0],
                                   p[:, 3] - p[:, 1]).min()) >= 24.0


def test_the_sample_priority_is_tpudets():
    from tpudet_torch.models.dense_heads.rpn_head import fixed_priority
    got = fixed_priority(1000, 0, 'cpu').numpy()
    np.testing.assert_array_equal(
        got, np.random.RandomState(0).rand(1000).astype(np.float32))
