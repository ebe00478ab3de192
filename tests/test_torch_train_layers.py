"""Train mode of the port's layers against tpudet on the CPU, in fp32:
BatchNorm's normalization and its running statistics, the SPP max-pool and
the nearest upsample with their gradients, the compute dtype with fp32
parameters, and the way back from a model to tpudet's trees.

BatchNorm runs at n = 8 values per channel (batch 2 of 2x2 maps), where
torch's unbiased running variance would be 8/7 = 14 % above flax's biased
one. The max-pool input is drawn continuous, so every window has a unique
maximum (at a tie the two frameworks may route the gradient to different
elements).

Tolerances: BN outputs and statistics rtol 1e-5 with atol 1e-6 (fp32 sums
of 8 values in other orders, E[x^2] - E[x]^2 in flax against a two-pass
variance); pool and upsample values exact, their gradients rtol and atol
1e-6 (a pixel that is the maximum of many windows, or the source of four
upsampled ones, sums their cotangents in another order); the round trips
exact.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.layers import BatchNormAct as JaxBatchNormAct
from tpudet.models.layers import ConvModule as JaxConvModule
from tpudet.models.layers import max_pool_same as jax_max_pool_same
from tpudet.models.layers import upsample_nearest_2x as jax_upsample
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.layers import (BatchNormAct, Conv, ConvModule,
                                        max_pool_same, upsample_nearest_2x)
from tpudet_torch.train.optim import YoloSGDConfig
from tpudet_torch.utils.flax_import import (load_flax_variables,
                                            random_flax_variables,
                                            state_dict_to_flax,
                                            train_state_from_flax,
                                            train_state_to_flax)

CIN, COUT = 6, 5
DARKNET_BN = dict(bn_eps=1e-3, bn_momentum=0.97)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _random_variables(shapes, rng):
    def draw(path, s):
        name = path[-1].key
        if name == 'kernel':
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.2).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


class _Wrap(torch.nn.Module):
    """Holds one port block under the flax name ``block``."""

    def __init__(self, block):
        super().__init__()
        self.block = block


@pytest.mark.parametrize('kind', ['conv_module', 'bn_act'])
def test_batchnorm_train_mode_matches_flax(kind):
    rng = np.random.RandomState(0)
    cin = CIN if kind == 'conv_module' else COUT
    x = rng.randn(2, 2, 2, cin).astype(np.float32) * 2 + 0.5
    if kind == 'conv_module':
        jblock = JaxConvModule(features=COUT, kernel_size=3, **DARKNET_BN)
        block = ConvModule(CIN, COUT, 3)
    else:
        jblock = JaxBatchNormAct(**DARKNET_BN)
        block = BatchNormAct(COUT)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    variables = _random_variables(shapes, rng)
    ref, mutated = jblock.apply(variables, jnp.asarray(x), train=True,
                                mutable=['batch_stats'])
    wrap = _Wrap(block)
    load_flax_variables(wrap, {c: {'block': v} for c, v in variables.items()})
    wrap.train()
    got = block(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    new_stats = state_dict_to_flax(wrap)['batch_stats']['block']
    for name in ('mean', 'var'):
        np.testing.assert_allclose(
            new_stats['bn'][name],
            np.asarray(mutated['batch_stats']['bn'][name]), rtol=1e-5,
            atol=1e-6, err_msg=name)
    # what torch's own rule would have stored: measurably off at n = 8
    old = variables['batch_stats']['bn']['var']
    moved = np.asarray(mutated['batch_stats']['bn']['var']) - 0.97 * old
    torch_rule = 0.97 * old + moved * 8 / 7
    assert np.abs(torch_rule - new_stats['bn']['var']).max() > 1e-3
    assert int(block.bn.num_batches_tracked) == 1


def test_batchnorm_eval_mode_leaves_statistics():
    block = ConvModule(CIN, COUT, 1).eval()
    before = block.bn.running_var.clone()
    block(torch.randn(2, CIN, 3, 3))
    assert torch.equal(block.bn.running_var, before)


@pytest.mark.parametrize('k', [5, 9, 13])
def test_max_pool_same_value_and_gradient(k):
    rng = np.random.RandomState(k)
    x = rng.randn(2, 11, 7, 3).astype(np.float32)
    cot = rng.randn(2, 11, 7, 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_max_pool_same(a, k), jnp.asarray(x))
    ref_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    xt = _nchw(x).requires_grad_()
    got = max_pool_same(xt, k)
    got.backward(_nchw(cot))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    np.testing.assert_allclose(_nhwc(xt.grad), ref_grad, rtol=1e-6,
                               atol=1e-6)
    assert (ref_grad != 0).mean() < 0.9  # the pool picked maxima


def test_upsample_value_and_gradient():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    cot = rng.randn(2, 6, 10, 4).astype(np.float32)
    ref, vjp = jax.vjp(jax_upsample, jnp.asarray(x))
    ref_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    xt = _nchw(x).requires_grad_()
    got = upsample_nearest_2x(xt)
    got.backward(_nchw(cot))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    np.testing.assert_allclose(_nhwc(xt.grad), ref_grad, rtol=1e-6,
                               atol=1e-6)


def test_conv_computes_in_its_input_dtype_with_fp32_params():
    """flax's ``nn.Conv(dtype=bf16)``: fp32 params, cast at the call; the
    gradient lands on the fp32 params."""
    conv = Conv(4, 3, 3, padding=1, bias=True)
    x = torch.randn(2, 4, 5, 5).to(torch.bfloat16)
    y = conv(x)
    assert y.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    ref = torch.nn.functional.conv2d(x, conv.weight.to(torch.bfloat16),
                                     conv.bias.to(torch.bfloat16), padding=1)
    assert torch.equal(y, ref)
    y.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32


def _tiny():
    return build_detector(dict(
        type='SingleStageDetector',
        backbone=dict(type='DarknetCSP', scale='v4s5p', out_indices=[3, 4, 5]),
        neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
                  out_channels=[32, 32, 32], csp_repetition=1),
        bbox_head=dict(type='YOLOCSPHead', num_classes=3,
                       in_channels=[32, 32, 32])))


def test_state_dict_to_flax_round_trip():
    model = _tiny()
    tree = random_flax_variables(model, seed=3)
    back = state_dict_to_flax(load_flax_variables(model, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_train_state_round_trip_and_refusal():
    model = _tiny()
    rng = np.random.RandomState(4)
    v = random_flax_variables(model, seed=4)
    rand = lambda t: jax.tree.map(  # noqa: E731
        lambda a: rng.randn(*a.shape).astype(np.float32), t)
    fstate = SimpleNamespace(
        step=np.int32(7), params=rand(v['params']),
        batch_stats=rand(v['batch_stats']), ema_params=rand(v['params']),
        ema_batch_stats=rand(v['batch_stats']),
        opt_state=SimpleNamespace(momentum_buf=rand(v['params'])))
    state = train_state_from_flax(fstate, model, YoloSGDConfig())
    assert int(state.step) == 7
    assert state.params['backbone.conv0.conv.weight'] is \
        model.backbone.conv0.conv.weight
    back = train_state_to_flax(state, model)
    for name in ('params', 'batch_stats', 'ema_params', 'ema_batch_stats'):
        for a, b in zip(jax.tree.leaves(getattr(back, name)),
                        jax.tree.leaves(getattr(fstate, name))):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(back.opt_state.momentum_buf),
                    jax.tree.leaves(fstate.opt_state.momentum_buf)):
        np.testing.assert_array_equal(a, b)
    assert int(back.step) == 7

    fstate.ema_params['backbone']['extra'] = {'kernel': np.zeros(3)}
    with pytest.raises(KeyError, match='has no place'):
        train_state_from_flax(fstate, _tiny(), YoloSGDConfig())
    del fstate.ema_params['backbone']['extra']
    del fstate.opt_state.momentum_buf['backbone']['conv0']['conv']
    with pytest.raises(KeyError, match='not in the flax variables'):
        train_state_from_flax(fstate, _tiny(), YoloSGDConfig())

