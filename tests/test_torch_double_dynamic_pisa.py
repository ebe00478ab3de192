"""Double-Head R-CNN, Dynamic R-CNN and PISA (``DoubleConvFCBBoxHead``,
``DoubleHeadRoIHead``, ``DynamicRoIHead``, ``PISARoIHead`` and PISA's
weights) in tpudet_torch against tpudet, on the CPU.

- ``DoubleConvFCBBoxHead`` alone (narrowed to 64 conv channels) on random
  (N, 7, 7, C) features, BatchNorm in train mode over all N and in eval
  mode, and its input gradient, in float64: rtol 1e-6 (atol 1e-7 of the
  largest |value|); the BatchNorm
  statistics it moves rtol 1e-9;
- ISR-P's and CARL's weights in float64 on random IoUs with exact ties
  (ranks count the strictly greater, so ties share a rank): rtol 1e-12;
- the RoI heads' losses in float64 on tpudet's head outputs and the
  port's sampled rois (the head test of ``test_torch_roi_head.py``: 800
  rois an image): each term rtol 1e-6 and its gradients; Dynamic R-CNN's
  threshold (the mean of each gt's 75th IoU, floored at 0.4), its sampled
  rois equal to tpudet's index for index, and ``dynamic_beta``; the
  Double head's terms twice the standard ones;
- PISA's ``same_gt`` mask (bit-equal decoded targets) against tpudet's
  on a sampled batch in fp32 and in float64: equal on every pair whose
  boxes both packages decode alike (``exp`` may round an ulp apart), and
  the count of pairs of positives of one gt that it joins;
- the eval outputs of Dynamic R-CNN and of PISA's Faster R-CNN bit-equal
  to a ``FasterRCNN``'s on the same weights: only training differs;
- one float64 train step of each of the three detectors from the same
  random weights (ResNet-18, a 32-channel FPN, 16 sampled rois an image,
  8 for the Double head,
  every RoI head ReLU input moved above 0: RoIAlign's fp32 sample points
  round apart in the two packages), 2 images of 64 px: the losses and the
  gradient norm rtol 1e-4, the state within 5e-3 of the step's change.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core.bbox import DeltaXYWHBBoxCoder as JCoder
from tpudet.models.dense_heads import pisa_heads as jpisa
from tpudet.models.roi_heads.double_roi_head import \
    DoubleConvFCBBoxHead as JDoubleBBoxHead
from tpudet.models.roi_heads.double_roi_head import \
    DoubleHeadRoIHead as JDoubleRoIHead
from tpudet.models.roi_heads.dynamic_roi_head import \
    DynamicRoIHead as JDynamicRoIHead
from tpudet.models.roi_heads.pisa_roi_head import PISARoIHead as JPISARoIHead
from tpudet.models.roi_heads.standard_roi_head import \
    StandardRoIHead as JStandardRoIHead
from tpudet_torch.apis import init_detector
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.dense_heads import pisa_heads
from tpudet_torch.models.detectors.two_stage import FasterRCNN
from tpudet_torch.models.roi_heads import (DoubleConvFCBBoxHead,
                                           DoubleHeadRCNN, DoubleHeadRoIHead,
                                           DynamicRCNN, DynamicRoIHead,
                                           PISARoIHead, StandardRoIHead)
from tpudet_torch.utils.flax_import import (load_flax_variables,
                                            random_flax_variables)

from .test_torch_atss_gfl import assert_step_matches, gts, images
from .test_torch_backbone_neck import random_variables
from .test_torch_reppoints import drawn_step
from .test_torch_roi_head import CH, _feats, _proposals, _t
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

NUM_CLASSES = 3
ROI_KEYS = ('loss_cls', 'loss_bbox')
PISA_KEYS = ROI_KEYS + ('loss_carl',)


# the Double head's bbox head alone

@pytest.mark.parametrize('train', [True, False])
def test_double_bbox_head_and_its_input_gradient_match_tpudet(train):
    """In float64: in fp32 the two packages' rounding flips ReLU inputs
    near 0 behind the train-mode BatchNorms, which moves single gradient
    entries by a few per cent."""
    x = np.random.RandomState(30).randn(24, 7, 7, CH)
    jhead = JDoubleBBoxHead(num_classes=NUM_CLASSES, conv_out_channels=64,
                            fc_out_channels=32)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jhead.init, jax.random.PRNGKey(0), jnp.zeros(x.shape)), 31))
    head = DoubleConvFCBBoxHead(NUM_CLASSES, CH, conv_out_channels=64,
                                fc_out_channels=32)
    load_flax_variables(head, variables)
    head.double().train(train)
    w = [np.random.RandomState(32 + i).randn(*s)
         for i, s in enumerate(((24, NUM_CLASSES + 1),
                                (24, 4 * NUM_CLASSES)))]
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def jtotal(inp):
            outs, mutated = jhead.apply(v64, inp, train,
                                        mutable=['batch_stats'])
            return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), (
                outs, mutated)
        (_, (ref, mutated)), jg = jax.device_get(jax.jit(jax.value_and_grad(
            jtotal, has_aux=True))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    got = head(tx)
    sum((o * torch.from_numpy(wi)).sum() for o, wi in zip(got, w)).backward()
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=1e-6,
                                   atol=1e-7 * np.abs(r).max())
    np.testing.assert_allclose(tx.grad.numpy(), jg, rtol=1e-6,
                               atol=1e-7 * np.abs(jg).max())
    stats = mutated['batch_stats']
    for name in ('res_ds_bn', 'res_bn1', 'res_bn2'):
        np.testing.assert_allclose(
            getattr(head, name).running_mean.numpy(),
            stats[name]['mean'], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        head.conv_branch3.bn3.running_var.numpy(),
        stats['conv_branch3']['bn3']['var'], rtol=1e-9)


# PISA's weights

def test_isr_and_carl_weights_match_tpudet_with_ties():
    rng = np.random.RandomState(33)
    k = 40
    ious = np.round(rng.uniform(0.3, 1.0, k), 1)  # many exact ties
    labels = rng.randint(0, 3, k)
    gt_ids = rng.randint(0, 6, k)
    pos = rng.rand(k) > 0.2
    pp = pos[:, None] & pos[None, :]
    same_label = (labels[:, None] == labels[None, :]) & pp
    same_gt = same_label & (gt_ids[:, None] == gt_ids[None, :])
    score = rng.uniform(0, 1, k)
    with jax.enable_x64(True):
        ref = np.asarray(jpisa.isr_weights_masks(
            jnp.asarray(ious), jnp.asarray(same_gt), jnp.asarray(same_label),
            jnp.asarray(pos), 2.0, 0.0))
        ref_c = np.asarray(jpisa.carl_weights(jnp.asarray(score),
                                              jnp.asarray(pos), 1.0, 0.2))
    got = pisa_heads.isr_weights_masks(
        torch.from_numpy(ious), torch.from_numpy(same_gt),
        torch.from_numpy(same_label), torch.from_numpy(pos), 2.0, 0.0)
    got_c = pisa_heads.carl_weights(torch.from_numpy(score),
                                    torch.from_numpy(pos), 1.0, 0.2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    np.testing.assert_allclose(got_c.numpy(), ref_c, rtol=1e-12)
    assert len(np.unique(ref[pos])) < pos.sum()  # tied ranks share weights
    np.testing.assert_allclose(got_c.numpy().sum(), pos.sum(), rtol=1e-12)


# the RoI heads' losses

@pytest.fixture(scope='module')
def sampled_batch():
    """The port's StandardRoIHead sampling of the head test's rois (800 an
    image) and gts (image 0's), 128 slots an image, and random head
    outputs at them."""
    head = DynamicRoIHead(num_classes=NUM_CLASSES, in_channels=CH)
    props, valid = _proposals(1)
    boxes, labels, gvalid = gts(3, num_classes=NUM_CLASSES)
    samp = head.sample_rois(_t(props), _t(valid), _t(boxes), _t(labels),
                            _t(gvalid), num_samples=128)
    rng = np.random.RandomState(34)
    # deltas within about 0.3 of the targets: Dynamic R-CNN's beta (the
    # 20th smallest error) lands inside its clip
    deltas = np.tile(samp[3].numpy(), NUM_CLASSES) + rng.randn(
        2, 128, 4 * NUM_CLASSES) * 0.3
    outs = (rng.randn(2, 128, NUM_CLASSES + 1) * 2, deltas)
    return props, valid, boxes, labels, gvalid, samp, outs


def x64_roi_loss(jhead, head, sampled_batch, keys):
    """``loss`` of both packages in float64 on the same outputs and
    sampled rois: each term rtol 1e-6, the gradients rtol 1e-6. Returns
    the port's losses."""
    *_, samp, outs = sampled_batch
    rois, sampled, lab, targets, pos = samp
    args = [np.asarray(a) for a in (lab, targets, pos, sampled)]
    rois = rois.double().numpy()
    args[1] = args[1].astype(np.float64)
    variables = {'params': {}}
    with jax.enable_x64(True):
        def total(o):
            out = jhead.apply(variables, o[0], o[1],
                              *map(jnp.asarray, args), rois=jnp.asarray(rois),
                              method='loss')
            return sum(out[k] for k in keys), out
        (_, jl), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
            tuple(map(jnp.asarray, outs)))
        jl, jg = jax.device_get((jl, jg))
    touts = tuple(torch.tensor(a).requires_grad_() for a in outs)
    tl = head.loss(*touts, *map(torch.from_numpy, args),
                   rois=torch.from_numpy(rois))
    sum(tl[k] for k in keys).backward()
    assert set(tl) == set(jl) and int(pos.sum()) > 8
    for k in tl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-6, err_msg=k)
    for t, r in zip(touts, jg):
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-6,
                                   atol=1e-9 * np.abs(r).max())
    return {k: float(v.detach()) for k, v in tl.items()}


def test_double_head_loss_is_twice_the_standard_terms(sampled_batch):
    tl = x64_roi_loss(JDoubleRoIHead(num_classes=NUM_CLASSES,
                                     in_channels=CH),
                      DoubleHeadRoIHead(num_classes=NUM_CLASSES,
                                        in_channels=CH),
                      sampled_batch, ROI_KEYS)
    std = x64_roi_loss(JStandardRoIHead(num_classes=NUM_CLASSES,
                                        in_channels=CH),
                       StandardRoIHead(num_classes=NUM_CLASSES,
                                       in_channels=CH),
                       sampled_batch, ROI_KEYS)
    for k in ROI_KEYS:
        np.testing.assert_allclose(tl[k], 2 * std[k], rtol=1e-12)


def test_dynamic_loss_and_beta_match_tpudet(sampled_batch):
    tl = x64_roi_loss(JDynamicRoIHead(num_classes=NUM_CLASSES,
                                      in_channels=CH),
                      DynamicRoIHead(num_classes=NUM_CLASSES,
                                     in_channels=CH),
                      sampled_batch, ROI_KEYS)
    assert 1e-3 < tl['dynamic_beta'] < 1.0


@pytest.mark.parametrize('few', [False, True])
def test_dynamic_threshold_and_sampling_equal_tpudets(few):
    """The threshold and the sampled rois: with 100 close copies of each
    gt among the proposals the threshold rises over 0.4; with the head
    test's 60 rois an image the 75th IoU is the lowest, and the threshold
    floors at 0.4."""
    boxes, labels, gvalid = gts(3, num_classes=NUM_CLASSES)
    props, valid = _proposals(1)
    if few:
        props, valid = props[:, :60], valid[:, :60]
    else:
        rng = np.random.RandomState(38)
        src = np.repeat(boxes, 100, axis=1)  # (2, 600, 4)
        wh = (src[..., 2:] - src[..., :2])[..., [0, 1, 0, 1]]
        props = np.concatenate([props, (src + rng.uniform(
            -0.05, 0.05, src.shape) * wh).astype(np.float32)], 1)
        valid = np.concatenate([valid, np.repeat(gvalid, 100, axis=1)], 1)
    jhead = JDynamicRoIHead(num_classes=NUM_CLASSES, in_channels=CH)
    args = [props, valid, boxes, labels, gvalid]
    ref = jax.jit(lambda *a: jhead.apply({'params': {}}, *a,
                                         method='sample_rois'))(
        *map(jnp.asarray, args))
    head = DynamicRoIHead(num_classes=NUM_CLASSES, in_channels=CH)
    thr = head.iou_threshold(_t(props), _t(valid), _t(boxes), _t(gvalid))
    got = head.sample_rois(*map(_t, args))
    for name, g, r in zip(('rois', 'sampled', 'labels', 'targets', 'pos'),
                          got, ref):
        if name == 'targets':
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=name)
    if few:
        assert float(thr) == np.float32(0.4)
    else:
        # image 1 has no gt and counts 0 in the mean over images, as in
        # tpudet: the threshold is half image 0's
        assert 0.4 < float(thr) < 0.5
        std = super(DynamicRoIHead, head).sample_rois(*map(_t, args))
        assert not torch.equal(got[0], std[0])  # the sample moved


def test_pisa_loss_and_gradients_match_tpudet(sampled_batch):
    tl = x64_roi_loss(JPISARoIHead(num_classes=NUM_CLASSES, in_channels=CH),
                      PISARoIHead(num_classes=NUM_CLASSES, in_channels=CH),
                      sampled_batch, PISA_KEYS)
    assert all(tl[k] > 0 for k in PISA_KEYS)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_pisa_same_gt_mask_follows_tpudets(sampled_batch, dtype):
    """The port's ``same_gt`` mask (``pisa_roi_head.py:62, 80-81``: the
    decoded targets bit-equal) against tpudet's on the sampled batch's
    positives. The port decodes in tpudet's arithmetic order, but its
    ``exp`` may round a coordinate an ulp apart from XLA's (jitted and
    eager alike): the masks agree on every pair whose boxes decode alike. Few pairs of positives of one gt
    compare equal (the round trip is inexact). The counts are printed;
    ROADMAP.md §3 records them."""
    *_, boxes, _, gvalid, samp, outs = sampled_batch
    rois, _, lab, targets, pos = samp
    rois_np = rois.numpy().astype(dtype)
    targets_np = targets.numpy().astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        jgt = np.asarray(jax.jit(JCoder(target_stds=(0.1, 0.1, 0.2, 0.2)
                                        ).decode)(
            jnp.asarray(rois_np), jnp.asarray(targets_np))).reshape(-1, 4)
    head = PISARoIHead(num_classes=NUM_CLASSES, in_channels=CH)
    tgt = head.bbox_coder.decode(torch.from_numpy(rois_np),
                                 torch.from_numpy(targets_np)).reshape(-1, 4)
    reg = torch.from_numpy(outs[1]).reshape(2, 128, NUM_CLASSES, 4)[:, :, 0]
    order, _, o_pos, same_gt, same_label, n_all = head.rank_set(
        reg.to(tgt.dtype), lab, torch.from_numpy(targets_np), pos,
        torch.from_numpy(rois_np))
    o = order.numpy()
    assert n_all == 256 and o_pos.numpy().sum() == int(pos.sum())

    def mask(decoded):
        img = o // 128
        o_lab = lab.numpy().reshape(-1)[o]
        o_gt = decoded[o]
        pp = o_pos.numpy()[:, None] & o_pos.numpy()[None, :]
        return (pp & (o_lab[:, None] == o_lab[None, :]) &
                (img[:, None] == img[None, :]) &
                np.all(o_gt[:, None] == o_gt[None, :], -1))
    ref, own = mask(jgt), mask(tgt.numpy())
    np.testing.assert_array_equal(same_gt.numpy(), own)
    alike = np.all(jgt[o] == tgt.numpy()[o], -1)
    both = alike[:, None] & alike[None, :]
    np.testing.assert_array_equal(own[both], ref[both])
    # the pairs of positives of one gt: the gt its target decodes to
    # within 1e-3 px
    true = np.full(len(o), -1)
    for i, (im, box) in enumerate(zip(o // 128, tgt.numpy()[o])):
        if o_pos[i]:
            true[i] = im * 100 + int(np.argmax(np.abs(
                boxes[im] - box).max(-1) < 1e-3))
    one_gt = (true[:, None] == true[None, :]) & (true[:, None] >= 0) & \
        ~np.eye(len(o), dtype=bool)
    coords = int(((jgt[o] != tgt.numpy()[o]) & o_pos.numpy()[:, None]
                  ).sum())
    print(f'{np.dtype(dtype).name}: {coords} of {4 * int(pos.sum())} '
          f'positive coordinates decode apart; of {int(one_gt.sum())} '
          f'ordered pairs of positives of one gt, {int((ref & one_gt).sum())}'
          f' compare equal in tpudet, {int((own & one_gt).sum())} in the '
          f'port')
    assert one_gt.sum() > 0


# eval outputs: only training differs

@pytest.mark.parametrize('roi_head', ['DynamicRoIHead', 'PISARoIHead'])
def test_eval_outputs_are_bit_equal_to_faster_rcnn(roi_head):
    cfg = faster_cfg(roi_head, detector='DynamicRCNN' if roi_head ==
                     'DynamicRoIHead' else 'FasterRCNN')
    variables = random_flax_variables(build_detector(cfg), 35)
    base = dict(cfg, type='FasterRCNN', roi_head=dict(
        cfg['roi_head'], type='StandardRoIHead'))
    img = images(36)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    ref = init_detector(base, variables=variables, device='cpu',
                        dtype=torch.float32)
    assert type(ref.model) is FasterRCNN
    assert type(det.model.roi_head).__name__ == roi_head
    with torch.no_grad():
        for g, r in zip(det.model(torch.from_numpy(img)),
                        ref.model(torch.from_numpy(img))):
            assert torch.equal(g, r)
    for g, r in zip(det(img), ref(img)):
        assert torch.equal(g, r)


# the float64 steps

def faster_cfg(roi_head, detector='FasterRCNN', num_samples=16):
    """tpudet's R-CNN test config (``tests/test_models/
    test_roi_heads_extra.py``) with a 32-channel FPN, 5 classes and 16
    sampled rois an image."""
    return dict(
        type=detector,
        backbone=dict(type='ResNet', depth=18, out_indices=[0, 1, 2, 3]),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=32, feat_channels=32),
        roi_head=dict(type=roi_head, num_classes=5, in_channels=32,
                      num_samples=num_samples),
        train_cfg=dict(rpn_proposal=dict(nms_pre=100, max_per_img=50)),
        test_cfg=dict(rpn=dict(nms_pre=100, max_per_img=50),
                      rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                                max_per_img=10)))


def linear_rcnn_heads(params):
    """``params`` with every RoI head ReLU input moved above 0: the 2-FC
    head's and the Double head's FCs (biases raised, the next layer's
    kernel scaled down), the Double head's BatchNorms (bias 20, scale
    0.1)."""
    params = jax.tree.map(np.array, params)
    head = params['roi_head']['bbox_head']
    if 'shared_fc0' in head:
        head['shared_fc0']['bias'] += 30.
        head['shared_fc1']['kernel'] *= 0.1
        head['shared_fc1']['bias'] += 20.
    else:
        head['fc0']['bias'] += 30.
        head['fc1']['kernel'] *= 0.1
        head['fc1']['bias'] += 20.

        def lift(node):
            for k, v in node.items():
                if k.startswith(('res_', 'bn', 'ds_bn')) and 'scale' in v:
                    v['scale'] = np.full_like(v['scale'], 0.1)
                    v['bias'] = v['bias'] + 20.
                elif isinstance(v, dict):
                    lift(v)
        lift(head)
    for out in ('fc_cls', 'fc_reg'):
        head[out]['kernel'] *= 0.05
    return params


# (the RoI head, the detector, its losses, sampled rois an image: the
# Double head's 1024-wide conv branch takes 8, XLA's float64 convs on the
# CPU being plain loops)
STEPS = {'double_head': ('DoubleHeadRoIHead', 'DoubleHeadRCNN', ROI_KEYS, 8),
         'dynamic': ('DynamicRoIHead', 'DynamicRCNN', ROI_KEYS, 16),
         'pisa': ('PISARoIHead', 'FasterRCNN', PISA_KEYS, 16)}


@pytest.mark.parametrize('name', list(STEPS))
def test_a_train_step_matches_tpudet_in_float64(name):
    roi_head, detector, keys, num_samples = STEPS[name]
    state0, jstate, jm, tstate, tm, model = drawn_step(
        faster_cfg(roi_head, detector, num_samples), 37, forward_train=True,
        adjust=linear_rcnn_heads)
    assert type(model).__name__ == detector
    assert_step_matches(state0, jstate, jm, tstate, tm,
                        keys + ('loss_rpn_cls',))
    assert all(tm[k] > 0 for k in keys)
    if name == 'dynamic':
        np.testing.assert_allclose(tm['dynamic_beta'], jm['dynamic_beta'],
                                   rtol=1e-6)
