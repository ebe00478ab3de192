"""The slice as a whole in tpudet_torch against tpudet, on the CPU: a
narrow DCN Faster R-CNN, a narrow GCB Mask R-CNN and a narrow attention
Faster R-CNN (``configs/dcn/``, ``configs/gcnet/`` and
``configs/empirical_attention/`` on ResNet-50 of 8 base channels, an FPN
of 64 or 32 channels, 3 classes, 64 px, batches of 2): DCNv2 on c3-c5
as the configs have it (c5 alone in the float64 step, below),
ContextBlock (ratio 1/4) after conv3 of c3-c5, the attention
('1111', 8 heads, ``kv_stride`` 2) after conv2 of c4-c5, its ``gamma``
and biases drawn nonzero.

Tolerances, as ``test_torch_cascade_rcnn.py`` holds the two-stage zoo:

- forward (fp32, eval mode): every output within 1e-4 of its largest
  |value| (the valid slots equal);
- end to end, each package on its own forward: detections one-to-one, at
  least 99 % of tpudet's (boxes 1e-3 px, scores 1e-5);
- ``forward_train`` in float64 on both sides (BatchNorm in train mode):
  each loss rtol 1e-4, and each gradient rtol 1e-4 with atol 1e-4 of its
  leaf's largest |value|, with the RoI box head's ReLU inputs positive
  (``linear_heads``, asserted): RoIAlign's fp32 sample points round apart
  in the two packages. The GCB backbone trains in a Faster R-CNN here
  (``test_torch_mask_rcnn.py`` holds the mask branch's training).

The float64 step deforms c5 alone (its stride-2 block and two stride-1
blocks): the deformable sampling is fp32 in both packages, even in a
float64 run, and rounds apart (its sample points are fp32, ~1e-6 px at
these positions). Through c3-c5's 13 sites and their train-mode
BatchNorms that noise moves single gradient leaves far past the
tolerance below; through c5's 3 sites it stays well inside it. The fp32
forward and detections run c3-c5's 13 sites.
``test_torch_deform_conv.py`` holds the sampling and its gradient on
their own, and the configs' c3-c5 DCN builds in ``test_torch_configs.py``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.builder import build_detector as jax_build_detector
from tpudet_torch.apis import init_detector
from tpudet_torch.apis.train import forward_train_loss
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.plugins import ContextBlock, GeneralizedAttention
from tpudet_torch.ops.deform_conv import ModulatedDeformConv2d
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_backbone_neck import random_variables
from .test_torch_cascade_rcnn import _assert_heads_linear, linear_heads
from .test_torch_faster_rcnn import assert_one_to_one, frcnn_cfg
from .test_torch_faster_rcnn_train import f64, state_dict_to_flax_grads
from .test_torch_mask_rcnn import frame_masks, mask_rcnn_cfg
from .test_torch_rpn_head import gts
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KINDS = ['dcn_faster_rcnn', 'gcb_mask_rcnn', 'attention_faster_rcnn']
IMG = 64
WIDTHS = [32, 64, 128, 256]  # ResNet-50 of 8 base channels
GCB = dict(cfg=dict(type='ContextBlock', ratio=1. / 4),
           stages=(False, True, True, True), position='after_conv3')
GA = dict(cfg=dict(type='GeneralizedAttention', spatial_range=-1,
                   num_heads=8, attention_type='1111', kv_stride=2),
          stages=(False, False, True, True), position='after_conv2')
C3_C5 = (False, True, True, True)  # the configs' DCN stages
C5 = (False, False, False, True)  # the float64 step's


def zoo_cfg(kind, dcn=C3_C5):
    backbone = dict(type='ResNet', depth=50, base_channels=8,
                    out_indices=[0, 1, 2, 3])
    if kind == 'gcb_mask_rcnn':
        cfg = mask_rcnn_cfg()
        cfg['backbone'] = dict(backbone, plugins=[GCB])
    else:
        cfg = frcnn_cfg(num_samples=64)
        cfg['backbone'] = dict(backbone, **(
            dict(stage_with_dcn=list(dcn))
            if kind == 'dcn_faster_rcnn' else dict(plugins=[GA])))
    cfg['neck'] = dict(cfg['neck'], in_channels=WIDTHS)
    return cfg


def _img(seed, b=2):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (b, IMG, IMG, 3)).astype(np.float32)


def _variables(jmodel, kind, seed):
    """``random_variables`` of tpudet's tree (through ``forward_train`` for
    the Mask R-CNN), the RPN's deltas 10x narrower, the attention's
    ``gamma`` in [0.5, 1] and its biases N(0, 1)."""
    img = jnp.asarray(_img(0))
    if kind == 'gcb_mask_rcnn':  # the mask head's params exist only here
        boxes, labels, valid = gts(3, size=IMG)
        shapes = jax.eval_shape(
            partial(jmodel.init, method='forward_train'),
            jax.random.PRNGKey(0), img, boxes, labels, valid,
            frame_masks(0))
    else:
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), img)
    variables = jax.tree.map(np.asarray, random_variables(shapes, seed))
    reg = variables['params']['rpn_head']['rpn_reg']
    reg['kernel'] = reg['kernel'] * 0.1
    reg['bias'] = reg['bias'] * 0.1
    rng = np.random.RandomState(seed + 1)

    def draw(path, v):
        name = path[-1].key
        if name == 'gamma':
            return rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
        if name in ('key_content_bias', 'geom_bias'):
            return rng.randn(*v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope='module', params=KINDS)
def zoo_pair(request):
    kind = request.param
    cfg = zoo_cfg(kind)
    jmodel = jax_build_detector(cfg)
    variables = _variables(jmodel, kind, 6)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    img = _img(5)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = det.model(torch.from_numpy(img))
    return kind, cfg, jmodel, variables, det, img, ref, got


def test_forward_outputs_match_tpudet(zoo_pair):
    kind, _, _, variables, det, _, ref, got = zoo_pair
    backbone = det.model.backbone
    if kind == 'dcn_faster_rcnn':
        assert isinstance(backbone.layer2_0.conv2, ModulatedDeformConv2d)
        assert isinstance(backbone.layer4_0.conv2, ModulatedDeformConv2d)
        assert not isinstance(backbone.layer1_0.conv2, ModulatedDeformConv2d)
    elif kind == 'gcb_mask_rcnn':
        assert isinstance(backbone.layer2_3.plugin_after_conv3_0,
                          ContextBlock)
    else:
        assert isinstance(backbone.layer4_2.plugin_after_conv2_0,
                          GeneralizedAttention)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape
        if r.dtype == bool:
            np.testing.assert_array_equal(g, r)
        else:
            assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()


def test_detections_match_tpudet(zoo_pair):
    _, _, jmodel, _, det, _, ref, got = zoo_pair
    rj = jax.jit(jmodel.get_bboxes)(ref)
    rt = det.model.get_bboxes(got)
    assert int(rt.valid.sum(1).min()) >= 10
    assert_one_to_one(rt, rj, 1e-3)


def _float64_losses_and_gradients(cfg, jmodel, variables, batch, keys):
    """``forward_train`` of both packages in float64 (BatchNorm in train
    mode), the RoI box head made linear: (the port's losses, tpudet's,
    the port's gradients of the sum of the losses in ``keys`` by flax
    path, tpudet's)."""
    variables = dict(variables, params=linear_heads(variables['params']))
    v64 = f64(variables)

    def total(params, args):
        losses, _ = jmodel.apply(
            {'params': params, 'batch_stats': v64['batch_stats']}, *args,
            method='forward_train', mutable=['batch_stats'])
        return sum(losses[k] for k in keys), losses

    with jax.enable_x64(True):
        (_, jl), jg = jax.device_get(jax.jit(jax.value_and_grad(
            total, has_aux=True))(v64['params'],
                                  [jnp.asarray(v) for v in batch.values()]))
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    model.double().train()
    model.dtype = torch.float64
    tl = _assert_heads_linear(model, lambda: forward_train_loss(model)(
        {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert set(tl) == set(jl)
    sum(tl[k] for k in keys).backward()
    got = state_dict_to_flax_grads(model, {
        key: p.grad if p.grad is not None else torch.zeros_like(p)
        for key, p in model.named_parameters()})
    ref = {'/'.join(k.key for k in path): np.asarray(r)
           for path, r in jax.tree_util.tree_leaves_with_path(jg)}
    assert set(got) == set(ref)
    return tl, jl, got, ref


def _assert_gradients_close(got, ref):
    """Each leaf rtol 1e-4, atol 1e-4 of its largest |value|; a
    ContextBlock's ``conv_mask`` bias, whose gradient is 0 (the softmax
    does not move with a shift), within 1e-9 of its kernel's largest
    gradient on both sides. Returns the leaves with a gradient."""
    n = 0
    for name, r in ref.items():
        if name.endswith('conv_mask/bias'):
            scale = np.abs(ref[name[:-4] + 'kernel']).max()
            assert max(np.abs(got[name]).max(), np.abs(r).max()) <= \
                1e-9 * scale, name
            continue
        np.testing.assert_allclose(got[name], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)
        n += bool(np.abs(r).any())
    return n


@pytest.mark.parametrize('kind', KINDS)
def test_forward_train_losses_and_gradients_match_tpudet(kind):
    """The GCB backbone trains in a Faster R-CNN: tpudet's float64 Mask
    R-CNN ``forward_train`` compiles several times slower than its Faster
    R-CNN's, and the mask branch's training is
    ``test_torch_mask_rcnn.py``'s."""
    if kind == 'gcb_mask_rcnn':
        cfg = dict(zoo_cfg('attention_faster_rcnn'),
                   backbone=zoo_cfg(kind)['backbone'])
    else:
        cfg = zoo_cfg(kind, dcn=C5)
    jmodel = jax_build_detector(cfg)
    variables = _variables(jmodel, 'faster_rcnn', 6)
    boxes, labels, valid = gts(3, size=IMG)
    batch = dict(img=_img(7).astype(np.float64), gt_bboxes=boxes,
                 gt_labels=labels, gt_valid=valid)
    keys = ('loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox')
    tl, jl, got, ref = _float64_losses_and_gradients(cfg, jmodel, variables,
                                                     batch, keys)
    assert 'loss_mask' not in tl
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-4, err_msg=k)
    assert _assert_gradients_close(got, ref) > 100
    new = {'dcn_faster_rcnn': 'backbone/layer4_0/conv2/conv_offset/kernel',
           'gcb_mask_rcnn':
               'backbone/layer3_0/plugin_after_conv3_0/conv_mask/kernel',
           'attention_faster_rcnn':
               'backbone/layer3_0/plugin_after_conv2_0/geom_bias'}[kind]
    assert np.abs(got[new]).max() > 0
