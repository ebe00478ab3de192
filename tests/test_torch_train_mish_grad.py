"""Mish backward: tpudet_torch's plain gradient against tpudet on the CPU.

tpudet's backward Pallas kernel runs only on a TPU, so it is held here two
ways: through ``jax.grad`` of ``tpudet.ops.mish.mish_reference``, and
through the body of ``_mish_bwd_kernel`` itself, called on jnp arrays as
input refs and a numpy array as the output ref (``x_ref[...]`` reads
both). The port's CUDA kernel is held against the plain version on the
card by ``test_torch_mish_kernel.py``.

Tolerances: fp32 atol 1e-6 plus rtol 5e-6. XLA and PyTorch use different
CPU approximations of tanh, exp and log1p, and XLA's tanh returns exactly
1 past |x| ~ 7.9, where the fp32 tanh of softplus(x) is 1 - 2.4e-7: the
term x * (1 - t^2) then drops 8 * 4.8e-7 = 3.8e-6 of the gradient. fp16
and bf16 of the fp32-then-round form within 1 ulp of the output type.
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


def _ulp_error(got, ref, dtype):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), 2.0**MIN_EXP[dtype])
    ulp = 2.0 ** (np.floor(np.log2(mag)) - MANTISSA[dtype])
    return float((np.abs(got - ref) / ulp).max())


def test_reference_matches_jax_grad():
    x, g = _inputs()
    _, vjp = jax.vjp(jax_mish_reference, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(_port(x, g, 'float32'), ref, atol=1e-6,
                               rtol=5e-6)


def test_reference_matches_the_tpu_kernel_body_fp32():
    x, g = _inputs(1)
    np.testing.assert_allclose(_port(x, g, 'float32'),
                               _kernel_body(x, g, 'float32'), atol=1e-6,
                               rtol=5e-6)


@pytest.mark.parametrize('dtype', ['float16', 'bfloat16'])
def test_reference_matches_the_tpu_kernel_body_low_precision(dtype):
    x, g = _inputs(2)
    x, g = x[np.abs(x) < 60], g[np.abs(x) < 60]  # fp16 overflows past 65504
    assert _ulp_error(_port(x, g, dtype), _kernel_body(x, g, dtype),
                      dtype) <= 1


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
    """A CPU tensor that requires grad goes through ``MishFunction``: the
    plain forward, and the plain backward on the saved ``x``; no kernel
    launch is counted."""
    x, g = _inputs(3)
    xt = torch.from_numpy(x).reshape(1, -1, 1, 1).requires_grad_()
    gt = torch.from_numpy(g).reshape(xt.shape)
    before = (tmish.mish_cuda.launches, tmish.mish_backward_cuda.launches)
    y = tmish.mish_cuda(xt)
    assert y.grad_fn is not None and 'MishFunction' in type(y.grad_fn).__name__
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


def test_function_gradient_against_fp64_autograd():
    """The Function's fp32 gradient against autograd of the literal fp64
    chain (gradcheck-style, with an analytic reference): within 4 fp32 ulp
    of the gradient's scale."""
    x = torch.linspace(-12, 12, 2001, dtype=torch.float32)
    x32 = x.clone().requires_grad_()
    tmish.MishFunction.apply(x32).sum().backward()
    x64 = x.double().requires_grad_()
    (x64 * torch.tanh(torch.nn.functional.softplus(x64))).sum().backward()
    torch.testing.assert_close(x32.grad.double(), x64.grad,
                               atol=4 * 2.0**-23, rtol=4 * 2.0**-23)
