"""The GCNet and empirical-attention plugins, and ResNet with DCN and
plugins, in tpudet_torch against tpudet on the CPU: flax's
``nn.LayerNorm``, ``ContextBlock`` (``att`` / ``avg`` pooling,
``channel_add`` / ``channel_mul``), ``GeneralizedAttention`` (``'1111'``,
``'0010'`` and each single term, ``kv_stride`` 2 on odd sizes, a
narrow position embedding, ``gamma`` nonzero; ``q_stride`` other than 1
refused), a narrow ``ResNet(depth=50)`` with DCN on c3-c5 (``layer2``-
``layer4``, as the configs have it) and each plugin, and the new leaves of
``flax_import``
(the deformable kernel, LayerNorm's scale and bias, ``gamma``,
``key_content_bias``, ``geom_bias``, L2Norm's ``scale``).

Tolerances:

- LayerNorm within 2e-6 of the largest |value| (one normalization);
- each plugin within 1e-5, its gradients with respect to the input and
  every param within 1e-4 (rtol 1e-4, atol 1e-4 of each leaf's largest
  |value|);
- the ResNets within 1e-4 (fp32 through 16 blocks, the deformable
  sampling included);
- ``flax_import``: bit-equal round trips; ``random_flax_variables`` draws
  each new leaf by tpudet's initializer (the same constants; truncated
  normals within the same bound and of the same spread); the optimizer
  groups equal tpudet's ``param_group_label``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from tpudet.models.backbones.resnet import ResNet as JaxResNet
from tpudet.ops import deform_conv as jd
from tpudet.models.backbones.resnet import ResNeXt as JaxResNeXt
from tpudet.models.backbones.ssd_vgg import L2Norm as JaxL2Norm
from tpudet.models.plugins import ContextBlock as JaxContextBlock
from tpudet.models.plugins import GeneralizedAttention as JaxGA
from tpudet.train.optim import param_group_label
from tpudet_torch.models.backbones.resnet import ResNet, ResNeXt
from tpudet_torch.models.backbones.ssd_vgg import L2Norm
from tpudet_torch.models.plugins import (ContextBlock, GeneralizedAttention,
                                         LayerNorm, build_plugin)
from tpudet_torch.ops.deform_conv import ModulatedDeformConv2d
from tpudet_torch.train.optim import param_labels
from tpudet_torch.utils.flax_import import (DEFORM, _from_flax_layout,
                                            _to_flax_layout, leaf_table,
                                            load_flax_variables,
                                            random_flax_variables,
                                            state_dict_to_flax)

from .test_torch_backbone_neck import random_variables
from .test_torch_faster_rcnn_train import state_dict_to_flax_grads
from .test_torch_gn_ws import _carry, _close, _nhwc, _t
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

GCB = dict(cfg=dict(type='ContextBlock', ratio=1. / 4),
           stages=(False, True, True, True), position='after_conv3')
GA = dict(cfg=dict(type='GeneralizedAttention', spatial_range=-1,
                   num_heads=8, attention_type='1111', kv_stride=2),
          stages=(False, False, True, True), position='after_conv2')
# DCN on c3-c5, as configs/dcn/*_dconv_c3-c5_* have it: 13 sites, three
# of them stride 2
DCN = (False, True, True, True)


def _nonzero(variables, seed):
    """``variables`` with ``gamma``, ``key_content_bias`` and
    ``geom_bias`` drawn away from 0 (``random_variables`` draws them at
    0.1 scale; the attention's output must weigh in)."""
    rng = np.random.RandomState(seed)

    def draw(path, v):
        name = path[-1].key
        if name == 'gamma':
            return np.asarray(rng.uniform(0.5, 1.0, v.shape), np.float32)
        if name in ('key_content_bias', 'geom_bias'):
            return np.asarray(rng.randn(*v.shape), np.float32)
        return v
    return jax.tree_util.tree_map_with_path(draw, variables)


def test_layer_norm_matches_flax():
    x = _nhwc(1, (2, 3, 5, 12), -3., 5.)
    norm = LayerNorm(12)
    _, ref = _carry(fnn.LayerNorm(), norm, 2, x)
    with torch.no_grad():
        _close(norm(_t(x)).permute(0, 2, 3, 1), ref, 2e-6)
        xb = _t(x).bfloat16()
        assert torch.equal(norm(xb), norm(xb.float()).bfloat16())


@pytest.mark.parametrize('pooling', ['att', 'avg'])
@pytest.mark.parametrize('fusions', [('channel_add',), ('channel_mul',),
                                     ('channel_mul', 'channel_add')],
                         ids=['add', 'mul', 'mul_add'])
def test_context_block_matches_tpudet(pooling, fusions):
    kw = dict(ratio=1. / 4, pooling_type=pooling, fusion_types=fusions)
    x = _nhwc(3, (2, 7, 6, 16))
    block = ContextBlock(16, **kw)
    variables, ref = _carry(JaxContextBlock(in_channels=16, **kw), block, 4,
                            x)
    assert ('conv_mask' in variables['params']) == (pooling == 'att')
    with torch.no_grad():
        _close(block(_t(x)).permute(0, 2, 3, 1), ref, 1e-5)


def _ga_pair(kw, x, seed):
    block = GeneralizedAttention(x.shape[-1], **kw)
    jblock = JaxGA(in_channels=x.shape[-1], **kw)
    variables = jax.tree.map(np.asarray, _carry(jblock, block, seed, x)[0])
    variables = _nonzero(variables, seed + 1)
    load_flax_variables(block, variables)
    return jblock, block, variables


@pytest.mark.parametrize('kw', [
    dict(attention_type='1111'), dict(attention_type='0010'),
    dict(attention_type='1000'), dict(attention_type='0100'),
    dict(attention_type='0001'),
    dict(attention_type='1111', kv_stride=1, num_heads=4),
    dict(attention_type='1111', position_embedding_dim=8)],
    ids=['1111', '0010', '1000', '0100', '0001', 'kv1', 'pos8'])
def test_generalized_attention_matches_tpudet(kw):
    kw = dict(dict(spatial_range=-1, num_heads=8, kv_stride=2), **kw)
    x = _nhwc(5, (2, 9, 7, 32))  # odd sizes: 5 x 4 keys at kv_stride 2
    jblock, block, variables = _ga_pair(kw, x, 6)
    at = kw['attention_type']
    assert ('key_content_bias' in variables['params']) == (at[2] == '1')
    assert ('geom_bias' in variables['params']) == (at[3] == '1')
    assert ('appr_geom_x' in variables['params']) == (
        at[1] == '1' or at[3] == '1')
    ref = jblock.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = block(_t(x)).permute(0, 2, 3, 1)
    _close(got, ref, 1e-5)
    # the attention's share of the output is far above the tolerance
    assert np.abs(np.asarray(ref) - x).max() > 0.1 * np.abs(x).max()


def test_generalized_attention_refuses_a_spatial_range():
    with pytest.raises(NotImplementedError, match='spatial_range'):
        GeneralizedAttention(32, spatial_range=4)


def test_generalized_attention_refuses_a_q_stride():
    """tpudet resizes a ``q_stride`` > 1 output back by nearest
    neighbour; no reference config asks for it, and the port refuses it."""
    with pytest.raises(NotImplementedError, match='q_stride=2'):
        GeneralizedAttention(32, q_stride=2)


def _plugin_grads(jmodule, tmodule, x, variables, seed):
    """The gradients of ``sum(out * c)`` (``c`` a fixed random cotangent)
    with respect to the input and every param: {name: (port's,
    tpudet's)}, tpudet's by ``jax.grad``."""
    load_flax_variables(tmodule, variables)
    cot = np.random.RandomState(seed).randn(*x.shape).astype(np.float32)

    def total(params, xin):
        return jnp.sum(jmodule.apply({'params': params}, xin) * cot)

    jg_p, jg_x = jax.jit(jax.grad(total, argnums=(0, 1)))(
        variables['params'], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tmodule(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) *
     torch.from_numpy(cot)).sum().backward()
    got = state_dict_to_flax_grads(tmodule, {
        k: p.grad for k, p in tmodule.named_parameters()})
    out = {('x',): (xt.grad.numpy(), np.asarray(jg_x))}
    for path, r in _flat(jax.device_get(jg_p)).items():
        out[path] = (got['/'.join(path)], r)
    assert len(out) == len(got) + 1
    return out


@pytest.mark.parametrize('module', ['context_block', 'attention_1111'])
def test_plugin_gradients_match_tpudet(module):
    """A softmax does not move with a shift of its input, so the gradient
    of ``conv_mask``'s bias is 0: both packages' round to 0 within 1e-5 of
    the input gradient's largest |value|.
    Every other leaf within rtol 1e-4, atol 1e-4 of its largest
    |value|."""
    if module == 'context_block':
        kw = dict(ratio=1. / 4, fusion_types=('channel_mul', 'channel_add'))
        jmod, tmod = JaxContextBlock(in_channels=16, **kw), ContextBlock(
            16, **kw)
        x = _nhwc(7, (2, 7, 6, 16))
    else:
        kw = dict(spatial_range=-1, num_heads=4, kv_stride=2,
                  attention_type='1111')
        jmod, tmod = JaxGA(in_channels=16, **kw), GeneralizedAttention(
            16, **kw)
        x = _nhwc(9, (2, 7, 5, 16))
    variables = _nonzero(jax.tree.map(np.asarray, random_variables(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)),
        8)), 9)
    grads = _plugin_grads(jmod, tmod, x, variables, 10)
    x_scale = np.abs(grads[('x',)][1]).max()
    for path, (g, r) in grads.items():
        if path == ('conv_mask', 'bias'):
            for v in (g, r):
                assert np.abs(v).max() <= 1e-5 * x_scale
            continue
        assert np.abs(r).max() > 0, path
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=str(path))


def _resnet_pair(kw, x, seed):
    """The port's ResNet with ``random_variables`` (``_nonzero``) of
    tpudet's, tpudet's output on ``x``."""
    jmodel, model = JaxResNet(**kw), ResNet(**kw)
    variables = _nonzero(jax.tree.map(np.asarray, random_variables(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x)),
        seed)), seed + 1)
    load_flax_variables(model, variables)
    return model, variables, jax.jit(jmodel.apply)(variables, jnp.asarray(x))


@pytest.mark.parametrize('kw', [
    dict(plugins=[GCB]), dict(plugins=[GA]),
    dict(stage_with_dcn=DCN, plugins=[GCB, GA])],
    ids=['gcb', 'attention', 'dcn_gcb_attention'])
def test_resnet_with_dcn_and_plugins_matches_tpudet(kw):
    kw = dict(depth=50, base_channels=8, **kw)
    x = _nhwc(13, (2, 64, 64, 3))
    model, variables, ref = _resnet_pair(kw, x, 14)
    with torch.no_grad():
        got = model.eval()(_t(x))
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1), r, 1e-4)
    params = variables['params']
    if 'stage_with_dcn' in kw:
        assert isinstance(model.layer4_0.conv2, ModulatedDeformConv2d)
        assert params['layer4_0']['conv2']['kernel'].shape == (9, 64, 64)
        assert set(params['layer4_2']['conv2']) == {'kernel', 'conv_offset'}
        assert isinstance(model.layer2_0.conv2, ModulatedDeformConv2d)
        assert not isinstance(model.layer1_0.conv2, ModulatedDeformConv2d)
    names = {n for n, _ in model.layer3_0.named_children()
             if n.startswith('plugin_')}
    want = set()
    for i, p in enumerate(kw.get('plugins', ())):
        want.add(f'plugin_{p["position"]}_{i}')
    assert names == want == {n for n in params['layer3_0']
                             if n.startswith('plugin_')}
    if kw.get('plugins') == [GA]:  # stages 3-4 only
        assert not any(n.startswith('plugin_') for n in params['layer2_0'])


def test_resnext_with_dcn_is_refused_as_tpudet_refuses_it():
    kw = dict(depth=50, base_channels=8, groups=2, base_width=16,
              stage_with_dcn=(False, True, True, True))
    with pytest.raises(AssertionError, match='DCN \\+ grouped conv'):
        jax.eval_shape(JaxResNeXt(**kw).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 16, 16, 3)))
    with pytest.raises(NotImplementedError,
                       match='DCN \\+ grouped conv not supported.*resnet.py'
                             ':131'):
        ResNeXt(**kw)


def test_an_unknown_plugin_is_refused():
    with pytest.raises(NotImplementedError, match='rest of the zoo'):
        build_plugin(dict(type='NonLocal2d'), 16)


# ---------------------------------------------------------------------------
# flax_import and the optimizer groups of the new leaves

class JaxZoo(fnn.Module):
    """Every new leaf in one small flax module: a DCNv2 (no bias), a
    ContextBlock (both fusions), the attention ('1111') and L2Norm."""

    @fnn.compact
    def __call__(self, x):
        x = jd.ModulatedDeformConv2d(64, 3, 1, use_bias=False,
                                     name='dcn')(x)
        x = JaxContextBlock(64, ratio=1. / 4, fusion_types=(
            'channel_mul', 'channel_add'), name='gcb')(x)
        x = JaxGA(64, num_heads=8, attention_type='1111', name='ga')(x)
        return JaxL2Norm(name='l2_norm')(fnn.Conv(512, (1, 1),
                                                  name='proj')(x))


class Zoo(torch.nn.Module):
    """The port's ``JaxZoo``."""

    def __init__(self):
        super().__init__()
        self.dcn = ModulatedDeformConv2d(64, 64, 3, 1, bias=False)
        self.gcb = ContextBlock(64, ratio=1. / 4,
                                fusion_types=('channel_mul', 'channel_add'))
        self.ga = GeneralizedAttention(64, num_heads=8, attention_type='1111')
        self.proj = torch.nn.Conv2d(64, 512, 1)
        self.proj.kernel_init = 'lecun_normal'
        self.l2_norm = L2Norm(512)


NEW_LEAVES = ('deform_kernel', 'layer_norm_scale', 'layer_norm_bias', 'gamma',
              'key_content_bias', 'geom_bias', 'l2_norm_scale')


def _new_leaf(path):
    """Which of NEW_LEAVES a flax path is, or None."""
    name = path[-1]
    if name == 'kernel' and path[-2] == 'dcn':
        return 'deform_kernel'
    if path[-2].endswith('_ln'):
        return f'layer_norm_{name}'
    if name in ('gamma', 'key_content_bias', 'geom_bias'):
        return name
    if path[-2] == 'l2_norm':
        return 'l2_norm_scale'
    return None


@pytest.fixture(scope='module')
def zoo_trees():
    """tpudet's init of ``JaxZoo`` and the port's ``Zoo``."""
    jtree = jax.tree.map(np.asarray, jax.jit(JaxZoo().init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 6, 6, 64))))
    return jtree, Zoo()


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.mark.parametrize('leaf', NEW_LEAVES)
def test_each_new_leaf_round_trips_bit_equal(zoo_trees, leaf):
    tree, module = zoo_trees
    rng = np.random.RandomState(20)
    tree = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                        tree)
    load_flax_variables(module, tree)
    back = _flat(state_dict_to_flax(module))
    flat = _flat(tree)
    hits = [p for p in flat if _new_leaf(p[1:]) == leaf]
    assert hits
    assert set(back) == set(flat)
    for p in flat:
        assert back[p].tobytes() == flat[p].tobytes(), p
    if leaf == 'deform_kernel':
        # the torch weight is the conv layout of tpudet's (K*K, in, out)
        key = '.'.join(hits[0][1:-1]) + '.weight'
        w = dict(module.named_parameters())[key].detach().numpy()
        np.testing.assert_array_equal(
            w.reshape(w.shape[0], w.shape[1], 9).transpose(2, 1, 0),
            flat[hits[0]])
        # an Adam buffer's stacked (m, v) leading axis is kept
        stacked = np.stack([flat[hits[0]], -flat[hits[0]]])
        there = _from_flax_layout(stacked, DEFORM)
        assert there.shape == (2,) + w.shape
        assert _to_flax_layout(there, DEFORM).tobytes() == stacked.tobytes()


def test_new_leaves_draw_tpudets_initializers(zoo_trees):
    """``random_flax_variables`` against tpudet's ``init``: the constants
    equal (``conv_offset`` and the biases 0, LayerNorm's scale 1, L2Norm's
    20), every truncated normal inside its bound ``2 sqrt(g / fan_in) /
    0.8796`` (``g`` 2 for ``he_normal``, 1 for flax's default
    ``lecun_normal``) and reaching past half of it, with a std within 20 %
    of tpudet's draw on the leaves of 1024 values or more."""
    jtree, model = zoo_trees
    ours = _flat(random_flax_variables(model, seed=3))
    ref = _flat(jtree)
    assert set(ours) == set(ref)
    kinds = set()
    for path, r in ref.items():
        g = ours[path]
        assert g.shape == r.shape and g.dtype == np.float32, path
        if np.all(r == r.flat[0]):  # a constant initializer
            np.testing.assert_array_equal(g, r, err_msg=str(path))
            kinds.add(('const', float(r.flat[0])))
            continue
        assert path[-1] == 'kernel', path
        # the deformable kernel's he_normal; the plugins' lecun_normal
        # convs and Denses
        gain = 2.0 if path[-2] == 'dcn' else 1.0
        fan_in = int(np.prod(r.shape[:-1]))
        bound = 2 * math.sqrt(gain / fan_in) / .87962566103423978
        for v in (g, r):
            assert bound * 0.5 < np.abs(v).max() <= bound * (1 + 1e-6), path
        if r.size >= 1024:
            assert 0.8 < g.std() / r.std() < 1.25, path
        kinds.add(('normal', gain))
    assert {('const', 0.), ('const', 1.), ('normal', 1.),
            ('normal', 2.)} <= kinds
    offsets = [p for p in ref if 'conv_offset' in p]
    assert offsets and all(not ours[p].any() for p in offsets)
    assert (ours[('params', 'l2_norm', 'scale')] == 20.).all()
    assert ('const', 20.) in kinds


def test_new_leaves_take_tpudets_optimizer_groups(zoo_trees):
    jtree, model = zoo_trees
    for tree, module in ((jtree, model),):
        ref = {}
        jax.tree_util.tree_map_with_path(
            lambda p, v: ref.__setitem__(tuple(k.key for k in p),
                                         param_group_label(p, v)),
            tree['params'])
        labels = param_labels(module)
        got = {path[1:]: labels[key] for path, (key, _) in
               leaf_table(module).items() if path[0] == 'params'}
        assert got == ref
        # and each new leaf lands where tpudet's labels put it
        want = {'deform_kernel': 'weight',
                'layer_norm_scale': 'weight_nodecay',
                'layer_norm_bias': 'bias', 'gamma': 'bias',
                'key_content_bias': 'weight', 'geom_bias': 'weight',
                'l2_norm_scale': 'weight_nodecay'}
        for path, label in got.items():
            if _new_leaf(path):
                assert label == want[_new_leaf(path)], path
