"""DetectoRS (ROADMAP.md's zoo row i): the SAC backbone and the RFP neck in
tpudet_torch against tpudet, on the CPU, from numpy seeds, with every
leaf that tpudet inits at zero (``pre_context``, ``post_context``, the
switch's kernel, ``weight_diff``, ``rfp_conv``, ``rfp_weight``) drawn
away from it, so that the feedback and the switch are not identities.

Tolerances:

- ``SAConv2d`` (strides 1 and 2, groups 1 and 2) and ``SACBottleneck``
  with a feedback feature, fp32: the outputs within 1e-5 of their largest
  |value|, every gradient (input, feedback, parameters) within 1e-4 of
  its largest |value|; on a bf16 input both run the two 3x3s in fp32 and
  return fp32: within 2 bf16 ulps (2^-7) of the largest |value|;
- ``ASPP`` and ``RFP`` (a DetectoRS R-50 backbone pair, an FPN of 32,
  64 px, BatchNorm in eval mode): every level within 1e-4 of its largest
  |value|;
- the DetectoRS Faster R-CNN of the config narrowed to an FPN of 32 (the
  backbones stay R-50: ``DetectoRSResNet`` has depths 50 and 101 only),
  64 px, the backbones' BatchNorm scales x 0.3 (``tame_backbones``): the
  forward's outputs within 1e-4 of their largest |value|;
  ``forward_train`` in float64 on both sides: every loss rtol 1e-4; one
  ``init_trainer(...).step``: finite, the params moved.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.backbones.detectors_resnet import \
    SACBottleneck as JaxSACBottleneck
from tpudet.models.backbones.detectors_resnet import SAConv2d as JaxSAConv2d
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.necks.rfp import ASPP as JaxASPP
from tpudet_torch.models.backbones.detectors_resnet import (SACBottleneck,
                                                            SAConv2d)
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.necks.rfp import ASPP
from tpudet_torch.utils.flax_import import (_to_flax_layout, leaf_table,
                                            load_flax_variables)

from .test_torch_backbone_neck import random_variables
from .test_torch_htc_scnet import (assert_close, assert_losses_match,
                                   assert_trainer_steps, float64_losses,
                                   forward_train_args, mask_batch,
                                   variables_for)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

CH, NUM_CLASSES, BN_SCALE = 32, 3, 0.3
ZERO_INIT = ('pre_context', 'post_context', 'switch', 'weight_diff',
             'rfp_conv', 'rfp_weight')


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _variables(jmod, *args, seed=0):
    """``random_variables`` of ``jmod``'s tree: no leaf at zero, the
    zero-init ones included."""
    return jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), *args), seed))


def _param_grads(module):
    sd = dict(module.named_parameters())
    return {'/'.join(p[1:]): _to_flax_layout(sd[k].grad.numpy(), kind)
            for p, (k, kind) in leaf_table(module).items()
            if p[0] == 'params'}


def _assert_grads(got, ref):
    assert set(got) == set(ref)
    for name, r in ref.items():
        r = np.asarray(r)
        assert np.abs(got[name] - r).max() <= 1e-4 * np.abs(r).max(), name


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out['/'.join(prefix + (k,))] = np.asarray(v)
    return out


@pytest.mark.parametrize('stride,groups', [(1, 1), (2, 1), (2, 2)])
def test_saconv_and_its_gradients_match_tpudet(stride, groups):
    rng = np.random.RandomState(stride * 10 + groups)
    x = rng.randn(2, 10, 12, 8).astype(np.float32)
    jmod = JaxSAConv2d(features=12, stride=stride, groups=groups)
    variables = _variables(jmod, jnp.asarray(x))
    assert all(np.abs(variables['params'][k]['kernel'] if isinstance(
        variables['params'][k], dict) else variables['params'][k]).max() > 0
        for k in ('pre_context', 'post_context', 'switch', 'weight_diff'))
    mod = SAConv2d(8, 12, stride, groups)
    load_flax_variables(mod, variables)
    out = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    cot = rng.randn(*out.shape).astype(np.float32)
    jp, jx = jax.jit(jax.grad(
        lambda p, a: jnp.sum(jmod.apply({'params': p}, a) * cot),
        argnums=(0, 1)))(variables['params'], jnp.asarray(x))
    tx = _nchw(x).requires_grad_()
    got = mod(tx)
    (got * _nchw(cot)).sum().backward()
    assert np.abs(_nhwc(got) - out).max() <= 1e-5 * np.abs(out).max()
    _assert_grads({'x': _nhwc(tx.grad), **_param_grads(mod)},
                  {'x': jx, **_flat(jp)})


def test_saconv_computes_in_fp32_on_a_bf16_input():
    x = np.random.RandomState(7).randn(2, 8, 8, 8).astype(np.float32)
    jmod = JaxSAConv2d(features=8, stride=2, dtype=jnp.bfloat16)
    variables = _variables(jmod, jnp.asarray(x))
    ref = jmod.apply(variables, jnp.asarray(x, jnp.bfloat16))
    mod = SAConv2d(8, 8, 2)
    load_flax_variables(mod, variables)
    from tpudet_torch.models.layers import cast_weights
    cast_weights(mod, torch.bfloat16)  # the context convs; not the kernel
    assert mod.weight.dtype == torch.float32
    got = mod(_nchw(x).bfloat16())
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    ref = np.asarray(ref)
    assert np.abs(_nhwc(got) - ref).max() <= 2 ** -7 * np.abs(ref).max()


def test_sac_bottleneck_with_feedback_matches_tpudet():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    feed = rng.randn(2, 4, 4, 12).astype(np.float32)
    kw = dict(planes=8, stride=2, downsample=True, rfp=True, rfp_inplanes=12)
    jmod = JaxSACBottleneck(**kw)
    variables = _variables(jmod, jnp.asarray(x), jnp.asarray(feed))
    mod = SACBottleneck(16, **kw).eval()
    load_flax_variables(mod, variables)
    out = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x),
                                         jnp.asarray(feed)))
    cot = rng.randn(*out.shape).astype(np.float32)
    params = variables['params']
    jp, jx, jf = jax.jit(jax.grad(lambda p, a, f: jnp.sum(jmod.apply(
        {'params': p, 'batch_stats': variables['batch_stats']}, a, f) * cot),
        argnums=(0, 1, 2)))(params, jnp.asarray(x), jnp.asarray(feed))
    tx, tf = _nchw(x).requires_grad_(), _nchw(feed).requires_grad_()
    got = mod(tx, tf)
    (got * _nchw(cot)).sum().backward()
    assert np.abs(_nhwc(got) - out).max() <= 1e-5 * np.abs(out).max()
    _assert_grads({'x': _nhwc(tx.grad), 'feed': _nhwc(tf.grad),
                   **_param_grads(mod)},
                  {'x': jx, 'feed': jf, **_flat(jp)})
    # without feedback, the feedback conv's bias alone (tpudet's conv of
    # zeros)
    plain = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()
    assert np.abs(plain - out).max() > 0.1 * np.abs(out).max()


def test_aspp_matches_tpudet():
    x = np.random.RandomState(4).randn(2, 9, 11, 16).astype(np.float32)
    jmod = JaxASPP(out_channels=8)
    variables = _variables(jmod, jnp.asarray(x))
    mod = ASPP(16, 8)
    load_flax_variables(mod, variables)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
    assert got.shape == ref.shape == (2, 9, 11, 32)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# the detector

def detectors_cfg():
    """The repo's DetectoRS config narrowed to an FPN of 32 (an ASPP of 8
    a branch, the feedback's 32 channels)."""
    return dict(
        type='FasterRCNN',
        backbone=dict(type='DetectoRSResNet', depth=50, output_img=True),
        neck=dict(type='RFP', in_channels=[256, 512, 1024, 2048],
                  out_channels=CH, num_outs=5, rfp_steps=2,
                  aspp_out_channels=8,
                  rfp_backbone=dict(type='DetectoRSResNet', depth=50,
                                    rfp_inplanes=CH)),
        rpn_head=dict(type='RPNHead', in_channels=CH, feat_channels=CH),
        roi_head=dict(type='StandardRoIHead', num_classes=NUM_CLASSES,
                      in_channels=CH, num_samples=32),
        train_cfg=dict(rpn_proposal=dict(nms_pre=500, max_per_img=64,
                                         nms=dict(iou_threshold=0.7))),
        test_cfg=dict(rpn=dict(nms_pre=500, max_per_img=64,
                               nms=dict(iou_threshold=0.7)),
                      rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                                max_per_img=20)))


def tame_backbones(params):
    """Every BatchNorm scale of both backbones x BN_SCALE, in place: at
    N(0, 1/fan_in) kernels two R-50 passes grow the features to ~3e4 and
    the RPN's deltas to the coder's clamp, where fp32 rounding moves a
    proposal by 1 %."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == 'scale':
                node[k] = v * BN_SCALE
    walk(params['backbone'])
    walk(params['neck']['rfp_module0'])


@pytest.fixture(scope='module')
def pair():
    cfg = detectors_cfg()
    jmodel = jax_build_detector(cfg)
    batch = mask_batch(5)
    variables = variables_for(jmodel, batch, 6)
    tame_backbones(variables['params'])
    for leaf in ZERO_INIT:
        assert any(leaf in p for p in _flat(variables['params']))
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    return cfg, jmodel, variables, model.eval()


def test_rfp_neck_matches_tpudet(pair):
    _, jmodel, variables, model = pair
    img = mask_batch(7)['img'].astype(np.float32)
    feats = jax.jit(partial(jmodel.apply, method='extract_feat'))(
        variables, jnp.asarray(img))
    with torch.no_grad():
        got = model.extract_feat(torch.from_numpy(img))
    assert len(got) == 5
    assert_close([g.permute(0, 2, 3, 1) for g in got], feats)


def test_detector_forward_matches_tpudet(pair):
    _, jmodel, variables, model = pair
    img = mask_batch(8)['img'].astype(np.float32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert_close(got, ref)


def test_forward_train_losses_match_tpudet_in_float64(pair):
    cfg, jmodel, variables, _ = pair
    batch = mask_batch(23)
    del batch['gt_frame_masks']
    assert len(forward_train_args(jmodel, batch)) == 4
    jl, tl = float64_losses(cfg, variables, batch)
    assert_losses_match(jl, tl, ['loss_rpn_cls', 'loss_cls', 'loss_bbox'])
    assert_trainer_steps(cfg, batch, variables)
