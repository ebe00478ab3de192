"""Deformable convolution in tpudet_torch against tpudet, on the CPU:
``deform_sample``, ``deform_conv2d``, ``DeformConv2d`` (v1, offsets
given) and ``ModulatedDeformConv2d`` (v2, ``conv_offset`` predicting the
offsets and the sigmoid mask), at strides 1 and 2 on even and odd sizes,
with and without the mask, with offsets of a few pixels that reach
outside the map.

Tolerances:

- fp32 outputs within 1e-5 of the output's largest |value| (one fp32
  bilinear sum of four terms and a contraction);
- the gradients with respect to the input, the offsets, the mask logits
  and the kernel (and, for the module, ``conv_offset``'s params) against
  ``jax.grad`` with rtol 1e-4 and atol 1e-4 of each leaf's largest
  |value|;
- float64 inputs and params: both packages still sample in fp32 and
  return fp32, within 1e-5;
- ``conv_offset`` pads as flax's ``'SAME'``: (0, 1) on an even side at
  stride 2, (1, 1) on an odd one; a symmetric pad of 1 gives other
  offsets at stride 2 on an even side (shown).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.ops import deform_conv as jd
from tpudet_torch.ops import deform_conv as td
from tpudet_torch.utils.flax_import import load_flax_variables

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

K, C, OUT = 3, 5, 4
TOL = 1e-5
CASES = [(1, 8, 6), (1, 7, 9), (2, 8, 10), (2, 9, 7)]
IDS = ['s1_even', 's1_odd', 's2_even', 's2_odd']


def _inputs(seed, stride, h, w, b=2):
    """x, offsets (a few pixels; a tenth of them 6-8 px, out of the map
    near its edges), mask logits and a kernel, fp32 numpy."""
    rng = np.random.RandomState(seed)
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.randn(b, h, w, C).astype(np.float32)
    off = rng.randn(b, ho, wo, 2 * K * K) * 2.0
    far = rng.rand(*off.shape) < 0.1
    off[far] = np.sign(off[far]) * rng.uniform(6, 8, int(far.sum()))
    logits = rng.randn(b, ho, wo, K * K).astype(np.float32)
    kernel = (rng.randn(K * K, C, OUT) / np.sqrt(K * K * C)).astype(
        np.float32)
    return x, off.astype(np.float32), logits, kernel


def _sigmoid(a):
    return 1 / (1 + np.exp(-a))


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize('masked', [False, True], ids=['v1', 'v2'])
@pytest.mark.parametrize('stride,h,w', CASES, ids=IDS)
def test_deform_sample_and_conv_match_tpudet(stride, h, w, masked):
    x, off, logits, kernel = _inputs(1, stride, h, w)
    mask = _sigmoid(logits).astype(np.float32) if masked else None
    ref_taps = jd.deform_sample(jnp.asarray(x), jnp.asarray(off), K, stride,
                                mask=None if mask is None else
                                jnp.asarray(mask))
    got_taps = td.deform_sample(torch.from_numpy(x), torch.from_numpy(off),
                                K, stride, mask=None if mask is None else
                                torch.from_numpy(mask))
    _close(got_taps, ref_taps)
    # some taps read outside the map: those corners are 0, not clamped
    ys = (np.arange(off.shape[1]) * stride)[None, :, None, None] + \
        off[..., 0::2]
    assert (ys < -1).any() and (ys > h).any()
    ref = jd.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                           jnp.asarray(kernel), K, stride,
                           mask=None if mask is None else jnp.asarray(mask),
                           bias=jnp.full((OUT,), 0.5))
    got = td.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                           torch.from_numpy(kernel), K, stride,
                           mask=None if mask is None else
                           torch.from_numpy(mask),
                           bias=torch.full((OUT,), 0.5))
    _close(got, ref)


def test_dilation_matches_tpudet():
    x, off, _, kernel = _inputs(2, 1, 9, 8)
    ref = jd.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                           jnp.asarray(kernel), K, 1, dilation=2)
    got = td.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                           torch.from_numpy(kernel), K, 1, dilation=2)
    _close(got, ref)


def _module_pair(kind, stride, h, w, seed, bias=True):
    """tpudet's module and the port's with the same random variables
    (``conv_offset`` drawn too, not left at tpudet's zero init)."""
    x = _inputs(seed, stride, h, w)[0]
    if kind == 'v1':
        jmod = jd.DeformConv2d(OUT, K, stride, use_bias=bias)
        tmod = td.DeformConv2d(C, OUT, K, stride, bias=bias)
        ho, wo = -(-h // stride), -(-w // stride)
        args = (x, np.zeros((2, ho, wo, 2 * K * K), np.float32))
    else:
        jmod = jd.ModulatedDeformConv2d(OUT, K, stride, use_bias=bias)
        tmod = td.ModulatedDeformConv2d(C, OUT, K, stride, bias=bias)
        args = (x,)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, args))
    rng = np.random.RandomState(seed + 100)
    variables = jax.tree.map(
        lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)
    load_flax_variables(tmod, variables)
    return jmod, tmod, variables, x


@pytest.mark.parametrize('stride,h,w', CASES, ids=IDS)
@pytest.mark.parametrize('kind', ['v1', 'v2'])
def test_modules_match_tpudet(kind, stride, h, w):
    jmod, tmod, variables, x = _module_pair(kind, stride, h, w, 3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if kind == 'v1':
        off = _inputs(4, stride, h, w)[1]
        ref = jmod.apply(variables, jnp.asarray(x), jnp.asarray(off))
        got = tmod(xt, torch.from_numpy(off).permute(0, 3, 1, 2))
    else:
        assert set(variables['params']) == {'conv_offset', 'kernel', 'bias'}
        ref = jmod.apply(variables, jnp.asarray(x))
        got = tmod(xt)
    assert got.dtype == torch.float32
    _close(got.detach().permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize('size,pads', [(8, (0, 1)), (9, (1, 1))],
                         ids=['even', 'odd'])
def test_conv_offset_pads_as_flax_same(size, pads):
    """The offsets' conv at stride 2 pads (0, 1) on an even side and (1, 1)
    on an odd one; ``Conv(padding=1)`` would give other offsets on an even
    side, and so the port would sample elsewhere."""
    assert td.same_padding(size, 3, 2) == pads
    assert td.same_padding(size, 3, 1) == (1, 1)
    jmod, tmod, variables, x = _module_pair('v2', 2, size, size, 5)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    co = tmod.conv_offset
    with torch.no_grad():
        sym = torch.nn.functional.conv2d(xt, co.weight, co.bias, 2, 1)
        same = torch.nn.functional.conv2d(
            torch.nn.functional.pad(xt, (*pads, *pads)), co.weight, co.bias,
            2)
    ref = jmod.apply(variables, jnp.asarray(x))
    _close(tmod(xt).detach().permute(0, 2, 3, 1), ref)
    assert sym.shape == same.shape
    if pads == (0, 1):
        assert not torch.allclose(sym, same)
    else:
        assert torch.equal(sym, same)


@pytest.mark.parametrize('stride,h,w', [CASES[1], CASES[2]],
                         ids=[IDS[1], IDS[2]])
def test_gradients_match_jax_grad(stride, h, w):
    """d/d(x, offsets, mask logits, kernel, bias) of ``sum(out * c)``."""
    x, off, logits, kernel = _inputs(6, stride, h, w)
    bias = np.full((OUT,), 0.25, np.float32)
    ho, wo = off.shape[1:3]
    cot = np.random.RandomState(7).randn(2, ho, wo, OUT).astype(np.float32)

    def total(x, off, logits, kernel, bias):
        out = jd.deform_conv2d(x, off, kernel, K, stride,
                               mask=jax.nn.sigmoid(logits), bias=bias)
        return jnp.sum(out * cot)

    ref = jax.grad(total, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, off, logits, kernel, bias)))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (x, off, logits, kernel, bias)]
    out = td.deform_conv2d(leaves[0], leaves[1], leaves[3], K, stride,
                           mask=torch.sigmoid(leaves[2]), bias=leaves[4])
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, r in zip(('x', 'offsets', 'mask logits', 'kernel', 'bias'),
                          leaves, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_module_gradients_match_jax_grad():
    """``ModulatedDeformConv2d`` at stride 2 on an even size: the
    gradients of ``sum(out * c)`` with respect to the input and every
    param (``conv_offset``'s included) against ``jax.grad``."""
    jmod, tmod, variables, x = _module_pair('v2', 2, 8, 10, 8)
    cot = np.random.RandomState(9).randn(2, 4, 5, OUT).astype(np.float32)

    def total(params, xin):
        return jnp.sum(jmod.apply({'params': params}, xin) * cot)

    gp, gx = jax.grad(total, argnums=(0, 1))(variables['params'],
                                             jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tmod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (out * torch.from_numpy(cot)).sum().backward()
    pairs = [(xt.grad, gx),
             (td._kernel_kk_c_o(tmod.weight.grad), gp['kernel']),
             (tmod.bias.grad, gp['bias']),
             (tmod.conv_offset.weight.grad.permute(2, 3, 1, 0),
              gp['conv_offset']['kernel']),
             (tmod.conv_offset.bias.grad, gp['conv_offset']['bias'])]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_float64_inputs_still_sample_in_fp32():
    """float64 inputs and params: tpudet (x64) casts x, the offsets, the
    mask and the kernel to fp32, and so does the port; both return fp32."""
    jmod, tmod, variables, x = _module_pair('v2', 2, 9, 8, 10)
    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        ref = np.asarray(jmod.apply(v64, jnp.asarray(x64)))
    tmod.double()
    got = tmod(torch.from_numpy(x64).permute(0, 3, 1, 2))
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    _close(got.detach().permute(0, 2, 3, 1), ref)
    # a bf16 input: the offsets and the sampling still run in fp32
    tmod.float()
    xb = torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()
    with torch.no_grad():
        got_b = tmod(xb)
        want = tmod(xb.float())
    assert got_b.dtype == torch.float32 and torch.equal(got_b, want)
