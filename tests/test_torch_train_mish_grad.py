"""Mish backward: tpudet_torch's plain gradient against tpudet on the CPU.

tpudet's backward Pallas kernel runs only on a TPU, so it is held here two
ways: through ``jax.grad`` of ``tpudet.ops.mish.mish_reference``, and
through the body of ``_mish_bwd_kernel`` itself, called on jnp arrays as
input refs and a numpy array as the output ref (``x_ref[...]`` reads
both). The port's CUDA kernel is held against the plain version on the
card by ``test_torch_mish_kernel.py``.

The port computes ``mish'(x) = t + 4 x u (u+1) r r`` with ``u =
e^min(x, 20)``, ``r = 1 / (u(u+2) + 2)``, ``t = u(u+2) r``: the one-exp
rational form, in fp32; tpudet the literal ``t + x (1 - t^2) sigmoid(x)``.

Tolerances: fp32 atol 1e-6 plus rtol 5e-6. XLA and PyTorch use different
CPU approximations of tanh, exp and log1p, and XLA's tanh returns exactly
1 past |x| ~ 7.9, where the fp32 tanh of softplus(x) is 1 - 2.4e-7: the
term x * (1 - t^2) then drops 8 * 4.8e-7 = 3.8e-6 of the gradient. fp16
and bf16 of the fp32-then-round form within 1 ulp of the output type at
the gradient's scale, ``max(|dx|, |g|)``: mish' crosses zero at x ~
-1.1924, where ulps of the value itself mean nothing (there the two forms
differ by up to 8 bf16 ulps of a tiny value). Against an fp64 truth
within 3 fp32 ulps of 1.0 (the form measured 1.8 here) where ``u`` is
normal, and within ``2 |x| + 2`` units of 2^-149 where it is subnormal
(measured 1.1 |x|: u's own rounding, times |1 + x|, and the rounding of
the subnormal products).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpudet.ops.mish import _mish_bwd_kernel
from tpudet.ops.mish import mish_reference as jax_mish_reference
from tpudet_torch.ops import mish as tmish

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

TORCH = {'float32': torch.float32, 'float16': torch.float16,
         'bfloat16': torch.bfloat16}
NUMPY = {'float32': np.float32, 'float16': np.float16,
         'bfloat16': ml_dtypes.bfloat16}
MANTISSA = {'float32': 23, 'float16': 10, 'bfloat16': 7}
MIN_EXP = {'float32': -126, 'float16': -14, 'bfloat16': -126}


def _inputs(seed=0):
    """x over mish's working range and its tails, g drawn around 1."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([
        np.linspace(-30, 30, 4001), rng.randn(4096) * 4,
        [0., -0., 8., -8., 20., -20., 60., -60., 1e4, -1e4]]).astype(
            np.float32)
    g = (rng.randn(x.size) + 1.0).astype(np.float32)
    return x, g


def _kernel_body(x, g, dtype):
    """tpudet's ``_mish_bwd_kernel`` run as plain code on the CPU."""
    out = np.zeros(x.shape, NUMPY[dtype])
    _mish_bwd_kernel(jnp.asarray(x.astype(NUMPY[dtype])),
                     jnp.asarray(g.astype(NUMPY[dtype])), out)
    return out.astype(np.float32)


def _port(x, g, dtype):
    return tmish.mish_backward_reference(
        torch.from_numpy(x).to(TORCH[dtype]),
        torch.from_numpy(g).to(TORCH[dtype])).float().numpy()


def _ulp_error(got, ref, dtype, scale):
    """max |got - ref| in ulps of ``dtype`` at ``max(|ref|, scale)``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.maximum(np.abs(ref), np.abs(scale)),
                     2.0**MIN_EXP[dtype])
    ulp = 2.0 ** (np.floor(np.log2(mag)) - MANTISSA[dtype])
    return float((np.abs(got - ref) / ulp).max())


def _truth(x):
    """mish'(x) in fp64 of fp32 inputs, by autograd of the literal chain."""
    x64 = torch.from_numpy(x).double().requires_grad_()
    (x64 * torch.tanh(torch.nn.functional.softplus(x64))).sum().backward()
    return x64.grad.numpy()


# either side of the threshold (20), and the neighbourhood of mish's zero
# of slope (x ~ -1.1924)
EDGES = np.array([19.99, 20., 20.01, 1e4, -19.99, -20., -20.01,
                  *np.linspace(-1.25, -1.14, 23)], np.float32)


def _with_edges(seed):
    x, g = _inputs(seed)
    rng = np.random.RandomState(seed + 10)
    return (np.concatenate([x, EDGES]),
            np.concatenate([g, rng.randn(EDGES.size) + 1]).astype(np.float32))


def test_reference_matches_jax_grad():
    x, g = _with_edges(0)
    _, vjp = jax.vjp(jax_mish_reference, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(_port(x, g, 'float32'), ref, atol=1e-6,
                               rtol=5e-6)


def test_reference_matches_the_tpu_kernel_body_fp32():
    x, g = _with_edges(1)
    np.testing.assert_allclose(_port(x, g, 'float32'),
                               _kernel_body(x, g, 'float32'), atol=1e-6,
                               rtol=5e-6)


@pytest.mark.parametrize('dtype', ['float16', 'bfloat16'])
def test_reference_matches_the_tpu_kernel_body_low_precision(dtype):
    x, g = _with_edges(2)
    x, g = x[np.abs(x) < 60], g[np.abs(x) < 60]  # fp16 overflows past 65504
    gd = g.astype(NUMPY[dtype]).astype(np.float32)
    assert _ulp_error(_port(x, g, dtype), _kernel_body(x, g, dtype),
                      dtype, gd) <= 1


def test_threshold_gives_the_incoming_gradient():
    """From x = 20 on (and at +inf) mish' is 1, so dx is g itself in every
    dtype; just below, the rational form is within 1 fp32 ulp of 1."""
    x = torch.tensor([20., 20.01, 21., 88., 1e4, 3e38, float('inf')])
    g = torch.linspace(-3, 3, x.numel())
    for dtype in TORCH.values():
        gd = g.to(dtype)
        assert torch.equal(tmish.mish_backward_reference(x.to(dtype), gd), gd)
    below = np.array([19.99, 19.5], np.float32)
    np.testing.assert_allclose(_port(below, np.ones_like(below), 'float32'),
                               _truth(below), rtol=0, atol=2.0**-23)


def test_against_fp64_truth_where_u_is_normal():
    rng = np.random.RandomState(5)
    x = np.concatenate([np.linspace(-87.3, 30, 200001), rng.randn(50000) * 4,
                        EDGES]).astype(np.float32)
    err = np.abs(_port(x, np.ones_like(x), 'float32') - _truth(x))
    assert err.max() <= 3 * 2.0**-23, err.max() / 2.0**-23


def test_subnormal_u_range_against_fp64_truth():
    """x in [-104, -87]: u is subnormal (or 0 below -103.97), 2^-149
    apart, and mish' ~ u (1 + x) keeps that absolute error times |1 + x|,
    plus the rounding of the subnormal products. Nothing is flushed to
    zero."""
    x = np.linspace(-104, -87, 20001).astype(np.float32)
    got = _port(x, np.ones_like(x), 'float32').astype(np.float64)
    err = np.abs(got - _truth(x)) / 2.0**-149
    assert (err <= 2 * np.abs(x) + 2).all(), err.max()
    assert (got[x >= -103] < 0).all()


def test_infinities_take_the_limits():
    """``mish'(+inf) = 1``, ``mish'(-inf) = 0``; NaN stays NaN. tpudet's
    literal formula gives NaN at both infinities (a deliberate difference,
    ROADMAP.md section 3)."""
    x = torch.tensor([float('inf'), float('-inf'), float('nan'), 0.])
    g = torch.tensor([2., 3., 1., float('nan')])
    for dtype in TORCH.values():
        d = tmish.mish_backward_reference(x.to(dtype), g.to(dtype)).float()
        assert d[0] == 2 and d[1] == 0
        assert torch.isnan(d[2]) and torch.isnan(d[3])


def test_autograd_function_on_cpu_takes_the_plain_versions():
    """A CPU tensor that requires grad goes through ``tpudet::mish_fwd``'s
    autograd: the plain forward, and the plain backward on the saved
    ``x``; no kernel launch is counted."""
    x, g = _inputs(3)
    xt = torch.from_numpy(x).reshape(1, -1, 1, 1).requires_grad_()
    gt = torch.from_numpy(g).reshape(xt.shape)
    before = (tmish.mish_cuda.launches, tmish.mish_backward_cuda.launches)
    y = tmish.mish_cuda(xt)
    assert y.grad_fn is not None and (
        'tpudet_mish_fwd' in type(y.grad_fn).__name__)
    y.backward(gt)
    assert torch.equal(y.detach(), tmish.mish_reference(xt.detach()))
    assert torch.equal(xt.grad, tmish.mish_backward_reference(xt.detach(), gt))
    assert (tmish.mish_cuda.launches,
            tmish.mish_backward_cuda.launches) == before


def test_backward_brings_the_gradient_to_the_layout_of_x():
    """A channels_last ``x`` with a contiguous ``g`` gives the same gradient
    as with ``g`` in x's layout; a ``g`` of another shape raises."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 5, 3, 4).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    g = torch.from_numpy(rng.randn(2, 5, 3, 4).astype(np.float32))
    dx = tmish.mish_backward_cuda(x, g)
    assert torch.equal(dx, tmish.mish_backward_reference(x, g.contiguous(
        memory_format=torch.channels_last)))
    with pytest.raises(ValueError, match='does not match'):
        tmish.mish_backward_cuda(x, g[:1])


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize('case, want', [
    ('same layout', (2 * 8 * 3 * 5, 2 * 8 * 3 * 5)),
    ('channels_last concat slice', (8, 24)),
    ('contiguous concat slice', (8 * 3 * 5, 24 * 3 * 5)),
    ('contiguous against channels_last', None),
    ('broadcast', (1, 0)),
])
def test_gradient_rows_and_pitch(case, want):
    """How the backward kernel reads g beside x (``_g_rows``): in x's
    layout, as rows at a pitch (a channel slice of a concat's gradient,
    which autograd hands over as a view), or not at all (copied first)."""
    x = torch.zeros(2, 8, 3, 5)
    if case == 'same layout':
        x = g = _cl(x)
    elif case == 'channels_last concat slice':
        x, g = _cl(x), _cl(torch.zeros(2, 24, 3, 5))[:, 8:16]
    elif case == 'contiguous concat slice':
        g = torch.zeros(2, 24, 3, 5)[:, 16:]
    elif case == 'contiguous against channels_last':
        x, g = _cl(x), x
    else:
        g = torch.zeros(()).expand(x.shape)
    assert tmish._g_rows(x, g) == want


def test_function_gradient_against_fp64_autograd():
    """The op's fp32 gradient (tpudet::mish_fwd's autograd, whose
    backward is tpudet::mish_bwd) against autograd of the literal fp64
    chain (gradcheck-style, with an analytic reference): within 4 fp32 ulp
    of the gradient's scale."""
    x = torch.linspace(-12, 12, 2001, dtype=torch.float32)
    x32 = x.clone().requires_grad_()
    tmish.mish_cuda(x32).sum().backward()
    x64 = x.double().requires_grad_()
    (x64 * torch.tanh(torch.nn.functional.softplus(x64))).sum().backward()
    torch.testing.assert_close(x32.grad.double(), x64.grad,
                               atol=4 * 2.0**-23, rtol=4 * 2.0**-23)
