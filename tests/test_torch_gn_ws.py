"""GroupNorm and weight standardization in tpudet_torch against tpudet, on
the CPU in fp32: ``plugins.GroupNorm`` / ``make_norm('GN')``, ``WSConv``
(groups 1 and 2, with and without a bias), ``ResNet`` / ``ResNeXt`` with
GN and GN+WS (``BasicBlock``, ``Bottleneck``, the grouped ``Bottleneck``,
the downsample branch and the WS stem), ``FPN`` with GN and
``Shared4Conv1FCBBoxHead`` (plain, GN, GN+WS).

Tolerances: every output within 1e-4 of its largest |value| (the
modules' and ``test_torch_retinanet.py``'s yardstick); GroupNorm alone
within 2e-6 (one normalization, fp32 rounding). The backbones run in
float64 on both sides (jax's x64, the port's ``.double()``) and agree
within 1e-9: in fp32 ResNet-50 with GN+WS drifts to 1.5e-4, rounding
that sixteen standardized blocks compound. A bf16 input is
normalized with fp32 statistics: the bf16 output equals the fp32
computation on the same (bf16) values, rounded once. The weights carry
by name (``scale``/``bias`` of GN, ``kernel``/``bias`` of WS) and the
norms' parameters stay fp32 under ``set_dtype``, as do the WS convs'.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.backbones.resnet import ResNet as JaxResNet
from tpudet.models.backbones.resnet import ResNeXt as JaxResNeXt
from tpudet.models.necks.fpn import FPN as JaxFPN
from tpudet.models.plugins import WSConv as JaxWSConv
from tpudet.models.plugins import make_norm as jax_make_norm
from tpudet.models.roi_heads.bbox_head import (
    Shared4Conv1FCBBoxHead as JaxShared4Conv1FC)
from tpudet_torch.models.backbones.resnet import ResNet, ResNeXt
from tpudet_torch.models.layers import cast_weights
from tpudet_torch.models.necks.fpn import FPN
from tpudet_torch.models.plugins import GroupNorm, WSConv, make_norm
from tpudet_torch.models.roi_heads.bbox_head import Shared4Conv1FCBBoxHead
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_backbone_neck import _max_rel, random_variables
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

TOL = 1e-4


def _nhwc(seed, shape, lo=-2., hi=2.):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _carry(jmodule, tmodule, seed, *inputs):
    """tpudet's variables of ``jmodule`` on ``inputs`` (NHWC numpy) drawn
    from ``seed``, loaded into ``tmodule``: (variables, tpudet's output).
    float64 inputs run both sides in float64."""
    f64 = jax.tree.leaves(inputs)[0].dtype == np.float64
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jmodule.init, jax.random.PRNGKey(0),
        *jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), inputs)),
        seed))
    load_flax_variables(tmodule, variables)
    if not f64:
        return variables, jax.jit(jmodule.apply)(
            variables, *jax.tree.map(jnp.asarray, inputs))
    tmodule.double()
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        return variables, jax.device_get(jax.jit(jmodule.apply)(
            v64, *jax.tree.map(jnp.asarray, inputs)))


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert _max_rel(got, ref) <= tol


def _t(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize('groups', [8, 4])
def test_group_norm_matches_flax(groups):
    x = _nhwc(1, (2, 6, 5, 16), -3., 5.)
    jnorm = jax_make_norm('GN', train=True, gn_groups=groups)
    norm = make_norm('GN', 16, gn_groups=groups)
    assert isinstance(norm, GroupNorm)
    _, ref = _carry(jnorm, norm, 2, x)
    for mode in (norm.train, norm.eval):  # no running statistics
        mode()
        with torch.no_grad():
            _close(norm(_t(x)).permute(0, 2, 3, 1), ref, 2e-6)
    # channels_last input gives the same values
    with torch.no_grad():
        _close(norm(_t(x).contiguous(memory_format=torch.channels_last))
               .permute(0, 2, 3, 1), ref, 2e-6)


def test_group_norm_takes_fp32_statistics_of_a_bf16_input():
    x = torch.from_numpy(_nhwc(3, (2, 16, 9, 7), 40., 41.))
    norm = make_norm('GN', 16, gn_groups=4)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
        xb = x.bfloat16()
        got = norm(xb)
        want = norm(xb.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    # a bf16 mean over the 4 x 9 x 7 values near 40.5 would leave the
    # normalized values far off: they are within bf16's rounding
    assert float((got.float() - want.float()).abs().max()) == 0.


@pytest.mark.parametrize('kw', [
    dict(features=12, kernel_size=3), dict(features=12, kernel_size=3,
                                           stride=2, use_bias=True),
    dict(features=12, kernel_size=3, groups=2),
    dict(features=12, kernel_size=1)],
    ids=['k3', 'k3_s2_bias', 'k3_groups2', 'k1'])
def test_ws_conv_matches_tpudet(kw):
    x = _nhwc(4, (2, 9, 9, 8))
    conv = WSConv(8, kw['features'], kw['kernel_size'], kw.get('stride', 1),
                  groups=kw.get('groups', 1), bias=kw.get('use_bias', False))
    _, ref = _carry(JaxWSConv(**kw), conv, 5, x)
    with torch.no_grad():
        _close(conv(_t(x)).permute(0, 2, 3, 1), ref)
    # the standardized kernel: zero mean, and the unbiased std divided by
    # itself plus eps (not by sqrt(var + eps)), per output channel
    w = conv.standardized_weight().detach().double()
    assert float(w.mean((1, 2, 3)).abs().max()) < 1e-6
    std = conv.weight.detach().double().flatten(1).std(1)
    np.testing.assert_allclose(w.flatten(1).std(1).numpy(),
                               (std / (std + 1e-5)).numpy(), rtol=1e-6)


@pytest.mark.parametrize('kw', [
    dict(depth=18, norm='GN', gn_groups=4, conv_ws=True),
    dict(depth=50, base_channels=8, norm='GN', gn_groups=4),
    dict(depth=50, base_channels=8, norm='GN', gn_groups=4, conv_ws=True,
         out_indices=(1, 3))],
    ids=['r18_gn_ws', 'r50_gn', 'r50_gn_ws'])
def test_resnet_with_gn_and_ws_matches_tpudet(kw):
    x = _nhwc(6, (2, 64, 64, 3)).astype(np.float64)
    model = ResNet(**kw)
    _, ref = _carry(JaxResNet(**kw), model, 7, x)
    with torch.no_grad():
        got = model.eval()(_t(x))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        _close(g.permute(0, 2, 3, 1), r, 1e-9)
    assert isinstance(model.stem_bn, GroupNorm)
    assert isinstance(model.layer1_0.bn1, GroupNorm)
    assert isinstance(model.stem_conv, WSConv) == kw.get('conv_ws', False)
    assert hasattr(model, 'layer2_0') and hasattr(model.layer2_0, 'ds_conv')
    assert isinstance(model.layer2_0.ds_conv, WSConv) == kw.get('conv_ws',
                                                                False)


@pytest.mark.parametrize('conv_ws', [False, True], ids=['gn', 'gn_ws'])
def test_resnext_with_gn_matches_tpudet(conv_ws):
    """ResNeXt's grouped 3x3: grouped with GN; with WS tpudet's factory
    builds it ungrouped, and so does the port."""
    kw = dict(depth=50, base_channels=8, groups=2, base_width=16, norm='GN',
              gn_groups=4, conv_ws=conv_ws, out_indices=(0, 1))
    x = _nhwc(8, (2, 32, 32, 3)).astype(np.float64)
    model = ResNeXt(**kw)
    _, ref = _carry(JaxResNeXt(**kw), model, 9, x)
    with torch.no_grad():
        got = model.eval()(_t(x))
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1), r, 1e-9)
    assert model.layer1_0.conv2.groups == (1 if conv_ws else 2)


def test_fpn_with_gn_matches_tpudet():
    chans = [8, 16, 32, 64]
    rng = np.random.RandomState(10)
    feats = [rng.randn(2, 32 // 2**i, 32 // 2**i, c).astype(np.float32)
             for i, c in enumerate(chans)]
    kw = dict(in_channels=chans, out_channels=16, num_outs=5, norm='GN',
              gn_groups=4, add_extra_convs='on_input')
    fpn = FPN(**kw)
    variables, ref = _carry(JaxFPN(**kw), fpn, 11, feats)
    assert {'lateral_norm0', 'fpn_norm3'} <= set(variables['params'])
    with torch.no_grad():
        got = fpn([_t(f) for f in feats])
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1), r)


@pytest.mark.parametrize('kw', [dict(), dict(norm='GN', gn_groups=4),
                                dict(norm='GN', gn_groups=4, conv_ws=True)],
                         ids=['plain', 'gn', 'gn_ws'])
def test_shared4conv1fc_bbox_head_matches_tpudet(kw):
    kw = dict(num_classes=3, in_channels=8, conv_out_channels=16,
              fc_out_channels=32, **kw)
    x = _nhwc(12, (2, 5, 7, 7, 8))
    head = Shared4Conv1FCBBoxHead(**kw)
    variables, (rc, rr) = _carry(JaxShared4Conv1FC(**kw), head, 13, x)
    convs = variables['params']['shared_conv0']
    assert ('bias' in convs) == ('norm' not in kw)
    with torch.no_grad():
        cls, reg = head(torch.from_numpy(x))
    _close(cls, rc)
    _close(reg, rr)
    assert cls.shape == (2, 5, 4) and reg.shape == (2, 5, 12)


def test_set_dtype_keeps_norms_and_ws_convs_fp32():
    model = ResNet(depth=18, norm='GN', gn_groups=4, conv_ws=True)
    cast_weights(model, torch.bfloat16)
    assert model.stem_conv.weight.dtype == torch.float32
    assert model.stem_bn.weight.dtype == torch.float32
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, 3, 32, 32, dtype=torch.bfloat16))
    assert all(o.dtype == torch.bfloat16 for o in out)


def _grads_match(jmodule, tmodule, x, seed, tol=1e-4):
    """The gradients of ``sum(out * c)`` (``c`` a fixed random cotangent)
    with respect to the input and every param, tpudet's (``jax.grad``)
    against the port's (autograd), each within ``tol`` of its largest
    |value|."""
    variables, ref = _carry(jmodule, tmodule, seed, x)
    outs = ref if isinstance(ref, tuple) else (ref,)
    rng = np.random.RandomState(seed + 1)
    cots = [rng.randn(*np.shape(o)).astype(np.float32) for o in outs]

    def total(params, xin):
        out = jmodule.apply({**variables, 'params': params}, xin)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    jg_p, jg_x = jax.jit(jax.grad(total, argnums=(0, 1)))(
        variables['params'], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmodule(xt if x.ndim == 5 else xt.permute(0, 3, 1, 2))
    out = out if isinstance(out, tuple) else (out,)
    nhwc = [o if x.ndim == 5 else o.permute(0, 2, 3, 1) for o in out]
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(nhwc, cots)
        ).backward()
    _close(xt.grad, np.asarray(jg_x), tol)
    from tpudet_torch.utils.flax_import import _tree, leaf_table
    got = _tree(leaf_table(tmodule), {k: p.grad for k, p in
                                      tmodule.named_parameters()}, 'params')
    for (path, r), (_, g) in zip(jax.tree_util.tree_leaves_with_path(jg_p),
                                 jax.tree_util.tree_leaves_with_path(got)):
        _close(g, np.asarray(r), tol)
    assert len(jax.tree.leaves(got)) == len(jax.tree.leaves(jg_p))


@pytest.mark.parametrize('module', ['gn', 'ws_conv_groups2', 'head_gn_ws'])
def test_gradients_match_tpudet(module):
    if module == 'gn':
        _grads_match(jax_make_norm('GN', train=True, gn_groups=4),
                     make_norm('GN', 16, gn_groups=4),
                     _nhwc(14, (2, 6, 5, 16), -3., 5.), 15)
    elif module == 'ws_conv_groups2':
        kw = dict(features=12, kernel_size=3, groups=2, use_bias=True)
        _grads_match(JaxWSConv(**kw), WSConv(8, 12, 3, groups=2, bias=True),
                     _nhwc(16, (2, 9, 9, 8)), 17)
    else:
        kw = dict(num_classes=3, in_channels=8, conv_out_channels=16,
                  fc_out_channels=32, norm='GN', gn_groups=4, conv_ws=True)
        _grads_match(JaxShared4Conv1FC(**kw), Shared4Conv1FCBBoxHead(**kw),
                     _nhwc(18, (2, 5, 7, 7, 8)), 19)
