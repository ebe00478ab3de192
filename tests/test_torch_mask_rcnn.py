"""Mask R-CNN in the port against tpudet, on the CPU, from numpy seeds:
the masks' fill and targets (``tpudet_torch/core/mask.py``), the
transposed conv and its weights, ``FCNMaskHead``, ``MaskRoIHead``'s loss,
the whole ``MaskRCNN`` (ResNet-18 of 16 base channels, an FPN of 32, 3
classes, 96 px), the train pipeline's masks and the loader.

Tolerances:

- the polygon fill (``fill_poly``): equal to ``cv2.fillPoly`` on every
  pixel, over 500 random polygons (convex, concave, self-intersecting,
  multi-part, out of frame) in frames of 1-64 px and 28 x 28; the
  gt-frame masks and ``segmentation_to_bitmap``: equal to tpudet's;
- ``mask_targets_from_gt_frame``: atol 1e-5 (two small einsums);
- the transposed conv loaded from flax: atol 1e-5 of its largest output
  (exact up to fp32 summation), its weights back byte-equal;
- ``FCNMaskHead``: atol 1e-5 of the largest |logit|; ``mask_loss`` rtol
  1e-5 and its gradient with respect to the logits atol 1e-7;
- ``MaskRCNN`` (BatchNorm in eval mode, fp32): the forward's outputs
  within 1e-4 of each one's largest |value|, ``predict_masks`` on tpudet's
  detections within 1e-5; ``forward_train`` in float64 on both sides (as
  ``test_torch_faster_rcnn_train.py``): each loss rtol 1e-4; the mask
  branch (``FCNMaskHead`` + ``mask_loss`` on given pooled features) in
  float64: the loss rtol 1e-6, each mask-head gradient atol 1e-6 of its
  leaf's largest |value|. (Through RoIAlign the gradients drift further:
  the port places its samples in fp32 whatever the features' dtype, so
  the pooled features differ by ~1e-5 and ``conv0``'s gradient by 1.5e-3
  of its largest value; RoIAlign's own gradient is held in
  ``test_torch_roi_align.py``);
- the pipeline's masks: equal to tpudet's (flip, filter, affine chain
  with the same draws, the loader's collate).
"""
import random
from functools import partial

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tpudet.core import mask as jmask
from tpudet.data import pipelines as J
from tpudet.data.loader import DetDataLoader as JLoader
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.roi_heads.mask_head import FCNMaskHead as JaxFCNMaskHead
from tpudet.models.roi_heads.mask_head import MaskRoIHead as JaxMaskRoIHead
from tpudet.utils.checkpoint import save_variables as jax_save_variables
from tpudet_torch.apis import init_trainer
from tpudet_torch.config import Config
from tpudet_torch.core import mask as tmask
from tpudet_torch.data import DetDataLoader
from tpudet_torch.data import pipelines as P
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.layers import ConvTranspose
from tpudet_torch.models.roi_heads import (FCNMaskHead, MaskRCNN,
                                           MaskRoIHead)
from tpudet_torch.utils.checkpoint import load_variables, save_variables
from tpudet_torch.utils.flax_import import (_to_flax_layout, leaf_table,
                                            load_flax_variables,
                                            random_flax_variables,
                                            state_dict_to_flax)

from .test_torch_backbone_neck import random_variables
from .test_torch_rpn_head import gts
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG, NUM_CLASSES, CH = 96, 3, 32
FILL_KINDS = ('convex', 'concave', 'self_intersecting', 'multi_part',
              'out_of_frame')


def mask_rcnn_cfg():
    """A narrow Mask R-CNN: ResNet-18 of 16 base channels, an FPN of 32,
    3 classes, the config's RPN and RoI settings with fewer proposals."""
    return dict(
        type='MaskRCNN',
        backbone=dict(type='ResNet', depth=18, base_channels=16,
                      out_indices=[0, 1, 2, 3]),
        neck=dict(type='FPN', in_channels=[16, 32, 64, 128],
                  out_channels=CH, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=CH, feat_channels=CH),
        roi_head=dict(type='MaskRoIHead', num_classes=NUM_CLASSES,
                      in_channels=CH, num_samples=128),
        train_cfg=dict(rpn_proposal=dict(nms_pre=2000, max_per_img=300,
                                         nms=dict(iou_threshold=0.7))),
        test_cfg=dict(rpn=dict(nms_pre=1000, max_per_img=300,
                               nms=dict(iou_threshold=0.7)),
                      rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                                max_per_img=20)))


def _img(seed, b=2):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (b, IMG, IMG, 3)).astype(np.float32)


def frame_masks(seed, b=2, g=6, s=28):
    """Random binary gt-frame masks, a blob a gt."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:s, :s] + 0.5
    c = rng.uniform(0.3, 0.7, (b, g, 2, 1, 1)) * s
    r = rng.uniform(0.2, 0.5, (b, g, 1, 1)) * s
    return (((yy - c[:, :, 0]) ** 2 + (xx - c[:, :, 1]) ** 2) < r ** 2
            ).astype(np.float32)


def jax_init_tree(jmodel, img, seed):
    """A tpudet variables tree through ``forward_train`` (the mask head's
    params exist only there), kernels N(0, 1/fan_in), the RPN's deltas 10x
    narrower (as ``test_torch_faster_rcnn.det_variables``)."""
    boxes, labels, valid = gts(3, size=IMG)
    shapes = jax.eval_shape(
        partial(jmodel.init, method='forward_train'), jax.random.PRNGKey(0),
        jnp.asarray(img), boxes, labels, valid, frame_masks(0))
    variables = jax.tree.map(np.asarray, random_variables(shapes, seed))
    reg = variables['params']['rpn_head']['rpn_reg']
    reg['kernel'] = reg['kernel'] * 0.1
    reg['bias'] = reg['bias'] * 0.1
    return variables


@pytest.fixture(scope='module')
def pair():
    cfg = mask_rcnn_cfg()
    jmodel = jax_build_detector(cfg)
    variables = jax_init_tree(jmodel, _img(5), 6)
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    return cfg, jmodel, variables, model.eval()


# ---------------------------------------------------------------------------
# the fill and the gt-frame masks


def _polygons(rng, kind, h, w):
    """A call's polygons (int32 (N, 2) point arrays) of ``kind``."""
    side = max(h, w)
    if kind == 'multi_part':
        return [p for _ in range(rng.randint(2, 5))
                for p in _polygons(rng, 'self_intersecting', h, w)]
    n = rng.randint(3, 13)
    if kind in ('convex', 'concave'):
        c = rng.uniform(0, 1, 2) * [w, h]
        a = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(1, side, 1)
        if kind == 'concave':  # a star: every other point pulled in
            r = r * np.where(np.arange(n) % 2, rng.uniform(0.1, 0.5), 1.0)
        p = c + r[..., None] * np.stack([np.cos(a), np.sin(a)], 1)
    elif kind == 'self_intersecting':
        p = rng.uniform(-0.2, 1.2, (n, 2)) * [w, h]
    else:
        p = rng.uniform(-1.5, 2.5, (n, 2)) * [w, h]
    return [np.round(p).astype(np.int32)]


@pytest.mark.parametrize('kind', FILL_KINDS)
def test_fill_poly_equals_cv2(kind):
    rng = np.random.RandomState(FILL_KINDS.index(kind))
    for i in range(100):
        h, w = (28, 28) if i % 4 == 0 else rng.randint(1, 65, 2)
        polys = _polygons(rng, kind, h, w)
        ref = np.zeros((h, w), np.uint8)
        cv2.fillPoly(ref, polys, 1)
        got = tmask.fill_poly(polys, int(h), int(w)).numpy()
        assert np.array_equal(got, ref), (kind, i, h, w,
                                          [p.tolist() for p in polys])


def test_fill_polys_fills_each_group_alone():
    rng = np.random.RandomState(7)
    groups = [_polygons(rng, kind, 28, 28) for kind in FILL_KINDS] + [[]]
    got = tmask.fill_polys(groups, 28, 28).numpy()
    for g, polys in zip(got, groups):
        assert np.array_equal(g, tmask.fill_poly(polys, 28, 28).numpy())
    assert not got[-1].any()


def _gt(rng, degenerate=False):
    """A gt box and 1-3 polygons around it (some vertices outside)."""
    xy = rng.uniform(0, 200, 2)
    wh = rng.uniform(1, 150, 2)
    if degenerate:
        wh[rng.randint(2)] = 1e-4
    box = np.concatenate([xy, xy + wh]).astype(np.float32)
    polys = [rng.uniform(box[:2] - 0.1 * wh, box[2:] + 0.1 * wh,
                         (rng.randint(3, 15), 2)).reshape(-1).tolist()
             for _ in range(rng.randint(1, 4))]
    return box, polys


@pytest.mark.parametrize('size', [28, 56])
def test_gt_frame_masks_match_tpudet(size):
    rng = np.random.RandomState(size)
    for i in range(60):
        box, polys = _gt(rng, degenerate=i % 10 == 0)
        ref = jmask.polygons_to_gt_frame_mask(polys, box, size)
        got = tmask.polygons_to_gt_frame_mask(polys, box, size)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), ref)


def test_segmentation_to_bitmap_matches_tpudet():
    rng = np.random.RandomState(3)
    for i in range(40):
        _, polys = _gt(rng)
        h, w = rng.randint(150, 400, 2)
        # a polygon of fewer than 3 points is skipped
        segm = polys + [[5.0, 5.0, 60.0, 70.0]]
        assert np.array_equal(tmask.segmentation_to_bitmap(segm, h, w),
                              jmask.segmentation_to_bitmap(segm, h, w))
    rle = jmask.encode_rle(rng.rand(40, 30) > 0.5)
    for segm in (rle, None, [[1.0, 2.0, 3.0, 4.0]]):
        assert np.array_equal(tmask.segmentation_to_bitmap(segm, 40, 30),
                              jmask.segmentation_to_bitmap(segm, 40, 30))


def test_mask_targets_from_gt_frame_match_tpudet():
    rng = np.random.RandomState(4)
    p, s = 50, 28
    masks = (rng.rand(p, s, s) > 0.5).astype(np.float32)
    gt_boxes = np.concatenate([xy := rng.uniform(0, 100, (p, 2)),
                               xy + rng.uniform(1, 80, (p, 2))], 1)
    rois = gt_boxes + rng.uniform(-15, 15, (p, 4))
    gt_boxes[0, 2] = gt_boxes[0, 0]  # zero width: the 1e-3 clamp
    args = [a.astype(np.float32) for a in (masks, gt_boxes, rois)]
    ref = np.asarray(jmask.mask_targets_from_gt_frame(
        *[jnp.asarray(a) for a in args], 28))
    got = tmask.mask_targets_from_gt_frame(
        *[torch.from_numpy(a) for a in args], 28).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ---------------------------------------------------------------------------
# the transposed conv, the head, the loss


def test_conv_transpose_loaded_from_flax_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 7, 12).astype(np.float32)
    jconv = fnn.ConvTranspose(10, (2, 2), (2, 2))
    v = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(0), x))
    v['params']['bias'] = rng.randn(10).astype(np.float32)
    ref = np.asarray(jconv.apply(v, x))
    conv = ConvTranspose(12, 10, 2, stride=2)
    load_flax_variables(conv, v)
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).detach().numpy()
    assert got.shape == ref.shape == (2, 18, 14, 10)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    back = state_dict_to_flax(conv)['params']
    assert back['kernel'].tobytes() == v['params']['kernel'].tobytes()
    # unflipped, the two differ: the flip is what makes them agree
    k = np.ascontiguousarray(v['params']['kernel'].transpose(2, 3, 0, 1))
    conv.weight.data = torch.from_numpy(k)
    wrong = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).detach().numpy()
    assert np.abs(wrong - ref).max() > 0.1


def test_fcn_mask_head_matches_tpudet():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 14, 14, 16).astype(np.float32)
    jhead = JaxFCNMaskHead(num_classes=NUM_CLASSES, in_channels=16,
                           conv_out_channels=16)
    v = jax.tree.map(np.asarray, random_variables(
        jax.eval_shape(jhead.init, jax.random.PRNGKey(0), x), 2))
    ref = np.asarray(jhead.apply(v, x))
    head = FCNMaskHead(NUM_CLASSES, in_channels=16, conv_out_channels=16)
    load_flax_variables(head, v)
    got = head(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, 5, 28, 28, NUM_CLASSES)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_random_flax_variables_draw_the_mask_head_by_initializer():
    head = FCNMaskHead(80)
    tree = random_flax_variables(head, 0)['params']
    assert tree['conv_logits']['kernel'].std() == pytest.approx(0.001,
                                                               rel=0.05)
    for name in ('conv0', 'upsample'):
        k = tree[name]['kernel']
        assert k.shape[:3] == ((3, 3, 256) if name == 'conv0' else
                               (2, 2, 256))
        # he_normal: std sqrt(2 / fan_in), fan_in = H * W * in
        fan_in = np.prod(k.shape[:3])
        assert k.std() == pytest.approx(np.sqrt(2 / fan_in), rel=0.05)
        assert not tree[name]['bias'].any()


def _loss_inputs(seed, b=2, p=40, g=6):
    rng = np.random.RandomState(seed)
    boxes, labels, valid = gts(seed, b=b, g=g, size=IMG)
    rois = np.concatenate([xy := rng.uniform(0, 60, (b, p, 2)),
                           xy + rng.uniform(4, 40, (b, p, 2))], -1)
    return dict(
        mask_logits=rng.randn(b, p, 28, 28, NUM_CLASSES).astype(np.float32),
        rois=rois.astype(np.float32), pos=rng.rand(b, p) > 0.6,
        gt_idx=rng.randint(-1, g, (b, p)), gt_boxes=boxes,
        gt_frame_masks=frame_masks(seed, b, g),
        labels=rng.randint(0, NUM_CLASSES + 1, (b, p)))


def test_mask_loss_and_gradient_match_tpudet():
    inputs = _loss_inputs(3)
    jhead = JaxMaskRoIHead(num_classes=NUM_CLASSES, in_channels=CH)

    def loss(logits):
        args = dict(inputs, mask_logits=logits)
        return jhead.apply({'params': {}}, **{k: jnp.asarray(v) for k, v in
                                              args.items()},
                           method='mask_loss')['loss_mask']

    ref, ref_grad = jax.value_and_grad(loss)(jnp.asarray(
        inputs['mask_logits']))
    head = MaskRoIHead(NUM_CLASSES, in_channels=CH)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    t['mask_logits'].requires_grad_(True)
    got = head.mask_loss(**t)['loss_mask']
    got.backward()
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    np.testing.assert_allclose(t['mask_logits'].grad.numpy(),
                               np.asarray(ref_grad), atol=1e-7)
    # no positive slot: 0, not a division by zero
    none = dict(t, pos=torch.zeros_like(t['pos']))
    assert float(head.mask_loss(**none)['loss_mask']) == 0.0


# ---------------------------------------------------------------------------
# the detector


def test_mask_rcnn_param_tree_is_tpudets(pair):
    _, _, variables, model = pair
    ref = {p for p in _paths(variables)}
    assert set(leaf_table(model)) == ref
    assert any('upsample' in p for p in ref)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_mask_rcnn_forward_and_masks_match_tpudet(pair):
    _, jmodel, variables, model = pair
    img = _img(5)
    out_j = jmodel.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        out_t = model(torch.from_numpy(img))
    for a, b in zip(out_j, out_t):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(a).max(), 1.0)
    res = jmodel.get_bboxes(out_j)
    assert int(np.asarray(res.valid).sum()) > 10
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(img), res.bboxes,
                                  res.valid, method='predict_masks'))
    boxes = torch.from_numpy(np.asarray(res.bboxes))
    valid = torch.from_numpy(np.asarray(res.valid))
    with torch.no_grad():
        got = model.predict_masks(torch.from_numpy(img), boxes, valid)
        feats = model.extract_feat(torch.from_numpy(img))
        reused = model.predict_masks(None, boxes, valid, feats=feats)
    assert got.shape == ref.shape == (2, 20, 28, 28, NUM_CLASSES)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    assert torch.equal(reused, got)


def test_mask_rcnn_forward_train_matches_tpudet_in_float64(pair):
    cfg, jmodel, variables, _ = pair
    boxes, labels, valid = gts(3, size=IMG)
    batch = dict(img=_img(7).astype(np.float64), gt_bboxes=boxes,
                 gt_labels=labels, gt_valid=valid,
                 gt_frame_masks=frame_masks(9))
    v64 = _f64(variables)

    def losses(args):
        out, _ = jmodel.apply(v64, *args, method='forward_train',
                              mutable=['batch_stats'])
        return out

    with jax.enable_x64(True):
        jl = jax.device_get(jax.jit(losses)(
            [jnp.asarray(v) for v in batch.values()]))
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    model.double().train()
    model.dtype = torch.float64
    with torch.no_grad():
        tl = model.forward_train(*[torch.from_numpy(np.asarray(v))
                                   for v in batch.values()])
    assert set(tl) == set(jl) and 'loss_mask' in tl
    for k in jl:
        assert float(tl[k]) == pytest.approx(float(jl[k]), rel=1e-4), k


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def test_mask_branch_gradients_match_tpudet_in_float64(pair):
    """``FCNMaskHead`` and ``mask_loss`` on given pooled features (RoIAlign's
    gradient is held in ``test_torch_roi_align.py``): the loss and each
    mask-head parameter's gradient."""
    _, _, variables, model = pair
    rng = np.random.RandomState(11)
    inputs = _loss_inputs(12, p=24)
    pooled = rng.randn(2, 24, 14, 14, CH)
    head_vars = _f64(variables['params']['roi_head']['mask_head'])
    jmask_head = JaxFCNMaskHead(num_classes=NUM_CLASSES, in_channels=CH)
    jhead = JaxMaskRoIHead(num_classes=NUM_CLASSES, in_channels=CH)

    def loss(params):
        logits = jmask_head.apply({'params': params}, pooled)
        args = dict(inputs, mask_logits=logits)
        return jhead.apply({'params': {}}, **args,
                           method='mask_loss')['loss_mask']

    with jax.enable_x64(True):
        ref, grads = jax.device_get(jax.jit(jax.value_and_grad(loss))(
            head_vars))
    head = MaskRoIHead(NUM_CLASSES, in_channels=CH).double()
    head.load_state_dict(model.roi_head.state_dict())
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    logits = head.mask_head(torch.from_numpy(pooled))
    got = head.mask_loss(logits, t['rois'], t['pos'], t['gt_idx'],
                         t['gt_boxes'], t['gt_frame_masks'],
                         t['labels'])['loss_mask']
    got.backward()
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    sd = dict(head.named_parameters())
    for path, (key, kind) in leaf_table(head).items():
        if path[0] != 'params' or path[1] != 'mask_head':
            continue
        node = grads
        for p in path[2:]:
            node = node[p]
        ref_g = np.asarray(node)
        got_g = _to_flax_layout(sd[key].grad.numpy(), kind)
        assert np.abs(got_g - ref_g).max() <= 1e-6 * np.abs(ref_g).max(), (
            path, np.abs(got_g - ref_g).max(), np.abs(ref_g).max())


def test_trainer_steps_mask_rcnn_and_needs_the_masks(tmp_path):
    cfg = Config(dict(model=mask_rcnn_cfg(), data=dict(samples_per_gpu=2),
                      optimizer=dict(type='SGD', lr=0.01, momentum=0.9,
                                     nesterov=False)))
    trainer = init_trainer(cfg, device='cpu', max_steps=2)
    assert trainer.batch_keys[-1] == 'gt_frame_masks'
    boxes, labels, valid = gts(3, size=IMG)
    batch = dict(img=_img(2), gt_bboxes=boxes, gt_labels=labels,
                 gt_valid=valid, gt_frame_masks=frame_masks(4))
    metrics = trainer.step(batch)
    assert np.isfinite(float(metrics['loss_mask']))
    assert float(metrics['loss_mask']) > 0
    del batch['gt_frame_masks']
    with pytest.raises(TypeError, match='gt_frame_masks'):
        trainer.step(batch)


def test_mask_head_weights_cross_to_tpudets_file_byte_equal(pair, tmp_path):
    cfg, _, variables, _ = pair
    jax_save_variables(str(tmp_path / 'ref.msgpack'), variables)
    save_variables(str(tmp_path / 'got.msgpack'), variables)
    assert (tmp_path / 'got.msgpack').read_bytes() == \
        (tmp_path / 'ref.msgpack').read_bytes()
    # tpudet's file into the port and back out, every leaf byte-equal
    tree, _ = load_variables(str(tmp_path / 'ref.msgpack'))
    model = build_detector(cfg)
    load_flax_variables(model, tree)
    back = dict(_leaves(state_dict_to_flax(model)))
    ref = dict(_leaves(variables))
    assert set(back) == set(ref)
    assert any('mask_head' in k for k in ref)
    for k, v in ref.items():
        assert back[k].tobytes() == v.tobytes(), k


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ---------------------------------------------------------------------------
# the train pipeline's masks


def _ann(seed, n=5):
    rng = np.random.RandomState(seed)
    boxes, segs = [], []
    for i in range(n):
        box, polys = _gt(rng)
        boxes.append(box)
        segs.append(None if i == 1 else
                    dict(size=[9, 9], counts=[81]) if i == 2 else polys)
    return dict(bboxes=np.stack(boxes), labels=rng.randint(0, 3, n),
                masks=segs)


def _load(seed, size=28):
    ann = _ann(seed)
    ref = J.LoadAnnotations(with_mask=True, mask_frame_size=size)(
        dict(ann_info=ann))
    got = P.LoadAnnotations(with_mask=True, mask_frame_size=size,
                            device='cpu')(dict(ann_info=ann))
    return ref, got


def test_load_annotations_with_masks_matches_tpudet():
    ref, got = _load(0, 28)
    assert isinstance(got['gt_frame_masks'], torch.Tensor)
    assert np.array_equal(got['gt_frame_masks'].numpy(),
                          ref['gt_frame_masks'])
    # a missing or RLE segmentation: the full box
    assert got['gt_frame_masks'][1:3].eq(1).all()
    empty = P.LoadAnnotations(with_mask=True, device='cpu')(dict(
        ann_info=dict(bboxes=np.zeros((0, 4), np.float32),
                      labels=np.zeros(0, np.int64))))
    assert tuple(empty['gt_frame_masks'].shape) == (0, 28, 28)


def test_flip_and_filters_carry_the_masks_as_tpudet():
    ref, got = _load(1)
    img = np.random.RandomState(2).randint(0, 255, (240, 250, 3), np.uint8)
    ref['img'], got['img'] = img, img
    ref['bbox_fields'], got['bbox_fields'] = ['gt_bboxes'], ['gt_bboxes']
    random.seed(0)
    ref = J.RandomFlip(flip_ratio=1.0)(ref)
    got = P.RandomFlip(flip_ratio=1.0)(got)
    assert np.array_equal(got['gt_frame_masks'].numpy(),
                          ref['gt_frame_masks'])
    ref['gt_bboxes'][0, 2] = ref['gt_bboxes'][0, 0] + 1  # a thin box
    got['gt_bboxes'] = ref['gt_bboxes'].copy()
    ref = J.GtBBoxesFilter(2, 20)(ref)
    got = P.GtBBoxesFilter(2, 20)(got)
    assert len(ref['gt_bboxes']) == 4
    assert np.array_equal(got['gt_frame_masks'].numpy(),
                          ref['gt_frame_masks'])
    kw = dict(pad_to=400, crop=300, scale_limit=0.5, out=160)
    kept = []
    for seed in range(6):
        random.seed(seed)
        r = J.RandomAffineChain(**kw)(dict(ref, img=img))
        random.seed(seed)
        g = P.RandomAffineChain(**kw, device='cpu')(dict(got, img=img))
        assert np.array_equal(g['gt_frame_masks'].numpy(),
                              r['gt_frame_masks'])
        kept.append(len(r['gt_frame_masks']))
    assert min(kept) < 4  # some draws drop gts, and their masks


def test_loader_collates_the_masks_as_tpudet():
    samples = []
    for seed in (3, 4):
        ref, got = _load(seed)
        img = np.zeros((64, 80, 3), np.float32)
        samples.append((dict(ref, img=img), dict(got, img=img)))
    ref = JLoader([], 2, max_gts=4, img_size=96)._collate(
        [s[0] for s in samples])
    got = DetDataLoader([], 2, max_gts=4, img_size=96)._collate(
        [s[1] for s in samples])
    assert got['gt_frame_masks'].shape == (2, 4, 28, 28)
    assert np.array_equal(got['gt_frame_masks'].numpy(),
                          ref['gt_frame_masks'])
    plain = DetDataLoader([], 2, max_gts=4)._collate(
        [dict(img=np.zeros((8, 8, 3), np.float32))] * 2)
    assert 'gt_frame_masks' not in plain


def test_instaboost_still_raises():
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        P.Compose([dict(type='InstaBoost', prob=0.5)], device='cpu')


def test_mask_rcnn_classes_are_registered():
    assert MaskRCNN.__name__ == 'MaskRCNN'
    model = build_detector(mask_rcnn_cfg())
    assert isinstance(model.roi_head, MaskRoIHead)
    assert isinstance(model.roi_head.mask_head, FCNMaskHead)
