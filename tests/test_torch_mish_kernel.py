"""The CUDA mish kernels (forward and backward) against their plain
PyTorch versions, on the card.

Marked ``gpu``: skipped where no CUDA device is present. Imports no JAX,
so that it runs on a machine with a card and without JAX:

    python -m pytest tests/test_torch_mish_kernel.py -m gpu

Tolerances: fp32 <= 2 ulp; fp16 and bf16 <= 1 ulp of the output type
(both sides compute in fp32 and round once); layouts exact; the autograd
Function's fp32 gradient within 4 fp32 ulp of the gradient's scale
against autograd of the literal chain in fp64.
"""
import numpy as np
import pytest
import torch

from tpudet_torch.ops import mish

TORCH = {'float32': torch.float32, 'float16': torch.float16,
         'bfloat16': torch.bfloat16}
MANTISSA = {'float32': 23, 'float16': 10, 'bfloat16': 7}
MIN_EXP = {'float32': -126, 'float16': -14, 'bfloat16': -126}
ULP_TOL = {'float32': 2, 'float16': 1, 'bfloat16': 1}


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


SPECIAL = [0., -0., 8., -8., 20., -20., 88., -88., 1e4, -1e4, np.inf,
           -np.inf, np.nan]


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 4).astype(np.float32)
    x[:len(SPECIAL)] = SPECIAL
    return torch.from_numpy(x)


def _grads(n, seed):
    """Incoming gradients around 1, with a NaN and an inf among them."""
    g = np.random.RandomState(seed + 1).randn(n).astype(np.float32) + 1
    g[len(SPECIAL):len(SPECIAL) + 2] = [np.nan, np.inf]
    return torch.from_numpy(g)


def _ulp_error(got, ref, dtype):
    got, ref = got.double().cpu(), ref.double().cpu()
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(got[~fin & ~torch.isnan(ref)],
                       ref[~fin & ~torch.isnan(ref)])
    g, r = got[fin], ref[fin]
    mag = torch.clamp_min(r.abs(), 2.0 ** MIN_EXP[dtype])
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - MANTISSA[dtype])
    return float(((g - r).abs() / ulp).max())


@pytest.mark.gpu
@pytest.mark.parametrize('n', [1, 15, 1000003])
@pytest.mark.parametrize('dtype', ['float32', 'float16', 'bfloat16'])
def test_kernel_matches_plain(dtype, n):
    """Ragged sizes: the vector loop, the scalar tail, and both."""
    _card()
    x = _inputs(max(n, 16), seed=n)[:n].to('cuda', TORCH[dtype])
    before = mish.mish_cuda.launches
    got = mish.mish_cuda(x)
    torch.cuda.synchronize()
    assert mish.mish_cuda.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _ulp_error(got, mish.mish_reference(x), dtype) <= ULP_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_kernel_layouts_and_unaligned_views(dtype):
    """channels_last keeps its layout; a view 2 bytes past an aligned
    address takes the scalar path and agrees all the same."""
    _card()
    img = torch.randn(2, 16, 9, 7, device='cuda').to(TORCH[dtype])
    img = img.contiguous(memory_format=torch.channels_last)
    out = mish.mish_cuda(img)
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out, mish.mish_reference(img), atol=0, rtol=0)
    flat = torch.randn(4099, device='cuda').to(TORCH[dtype])[1:]
    torch.testing.assert_close(mish.mish_cuda(flat),
                               mish.mish_reference(flat), atol=0, rtol=0)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take():
    _card()
    with pytest.raises(TypeError):
        mish.mish_cuda(torch.zeros(8, device='cuda', dtype=torch.float64))
    with pytest.raises(ValueError):
        mish.mish_cuda(torch.zeros(8, 8, device='cuda').t())
    with pytest.raises(TypeError):
        mish.mish_backward_cuda(
            torch.zeros(8, device='cuda', dtype=torch.float64),
            torch.zeros(8, device='cuda', dtype=torch.float64))
    with pytest.raises(ValueError, match='does not match'):
        mish.mish_backward_cuda(torch.zeros(8, device='cuda'),
                                torch.zeros(8, device='cuda').half())
    empty = mish.mish_cuda(torch.zeros(0, device='cuda'))
    assert empty.shape == (0,)
    assert mish.mish_backward_cuda(empty, empty).shape == (0,)


@pytest.mark.gpu
@pytest.mark.parametrize('n', [1, 15, 1000003])
@pytest.mark.parametrize('dtype', ['float32', 'float16', 'bfloat16'])
def test_backward_kernel_matches_plain(dtype, n):
    """Ragged sizes and the special values (+-0, +-8, +-20, +-88, +-1e4,
    +-inf, NaN in x; NaN and inf in g)."""
    _card()
    x = _inputs(max(n, 16), seed=n)[:n].to('cuda', TORCH[dtype])
    g = _grads(max(n, 16), seed=n)[:n].to('cuda', TORCH[dtype])
    before = mish.mish_backward_cuda.launches
    got = mish.mish_backward_cuda(x, g)
    torch.cuda.synchronize()
    assert mish.mish_backward_cuda.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    ref = mish.mish_backward_reference(x, g)
    assert _ulp_error(got, ref, dtype) <= ULP_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_backward_layouts_and_mismatched_gradient_strides(dtype):
    """channels_last x with a contiguous g (autograd may hand one over):
    the wrapper brings g to x's strides; the result keeps x's layout. An
    unaligned view takes the scalar path."""
    _card()
    x = torch.randn(2, 16, 9, 7, device='cuda').to(TORCH[dtype]).contiguous(
        memory_format=torch.channels_last)
    g = torch.randn(2, 16, 9, 7, device='cuda').to(TORCH[dtype])
    got = mish.mish_backward_cuda(x, g)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, mish.mish_backward_reference(x, g),
                               atol=0, rtol=0)
    flat = torch.randn(4099, device='cuda').to(TORCH[dtype])[1:]
    gflat = torch.randn(4099, device='cuda').to(TORCH[dtype])[1:]
    torch.testing.assert_close(mish.mish_backward_cuda(flat, gflat),
                               mish.mish_backward_reference(flat, gflat),
                               atol=0, rtol=0)


@pytest.mark.gpu
def test_function_launches_both_kernels_and_matches_fp64_autograd():
    """A CUDA tensor that requires grad: the forward kernel, then on
    backward the backward kernel on the saved x; its fp32 gradient against
    autograd of the literal chain promoted to fp64."""
    _card()
    x = torch.linspace(-12, 12, 20001, device='cuda').reshape(1, 1, 1, -1)
    x32 = x.clone().requires_grad_()
    fwd, bwd = mish.mish_cuda.launches, mish.mish_backward_cuda.launches
    y = mish.mish_cuda(x32)
    y.sum().backward()
    torch.cuda.synchronize()
    assert mish.mish_cuda.launches == fwd + 1
    assert mish.mish_backward_cuda.launches == bwd + 1
    x64 = x.double().requires_grad_()
    (x64 * torch.tanh(torch.nn.functional.softplus(x64))).sum().backward()
    torch.testing.assert_close(x32.grad.double(), x64.grad,
                               atol=4 * 2.0**-23, rtol=4 * 2.0**-23)
