"""The CUDA mish kernels (forward and backward) against their plain
PyTorch versions, on the card.

Marked ``gpu``: skipped where no CUDA device is present. Imports no JAX,
so that it runs on a machine with a card and without JAX:

    python -m pytest tests/test_torch_mish_kernel.py -m gpu

Tolerances: the forward fp32 <= 2 ulp, fp16 and bf16 <= 1 ulp of the
output type; the backward the same, in ulps of the gradient's scale
``max(|dx|, |g|)`` (mish' crosses zero at x ~ -1.1924, where ulps of the
value mean nothing). Kernel and plain version take the same rounded steps
of the one-exp rational form and differ only where the card's expf and
PyTorch's exp do. Layouts exact; the autograd Function's fp32 gradient
within 4 fp32 ulp of the gradient's scale against autograd of the literal
chain in fp64.
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
           -np.inf, np.nan, 19.99, 20.01, -1.1924, -87., -90., -100., -104.]


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


def _ulp_error(got, ref, dtype, scale=None):
    """max |got - ref| over finite values in ulps of ``dtype`` at
    ``max(|ref|, |scale|)``; non-finite values must agree exactly."""
    got, ref = got.double().cpu(), ref.double().cpu()
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(got[~fin & ~torch.isnan(ref)],
                       ref[~fin & ~torch.isnan(ref)])
    g, r = got[fin], ref[fin]
    mag = r.abs()
    if scale is not None:
        mag = torch.maximum(mag, scale.double().cpu()[fin].abs())
    mag = torch.clamp_min(mag, 2.0 ** MIN_EXP[dtype])
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - MANTISSA[dtype])
    return float(((g - r).abs() / ulp).max())


@pytest.mark.gpu
@pytest.mark.parametrize('n', [1, 15, 1000003])
@pytest.mark.parametrize('dtype', ['float32', 'float16', 'bfloat16'])
def test_kernel_matches_plain(dtype, n):
    """Ragged sizes: the vector loop, the scalar tail, and both."""
    _card()
    x = _inputs(max(n, 32), seed=n)[:n].to('cuda', TORCH[dtype])
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
    +-inf, NaN, either side of 20, mish's zero of slope and the subnormal
    range of u in x; NaN and inf in g)."""
    _card()
    x = _inputs(max(n, 32), seed=n)[:n].to('cuda', TORCH[dtype])
    g = _grads(max(n, 32), seed=n)[:n].to('cuda', TORCH[dtype])
    before = mish.mish_backward_cuda.launches
    got = mish.mish_backward_cuda(x, g)
    torch.cuda.synchronize()
    assert mish.mish_backward_cuda.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    ref = mish.mish_backward_reference(x, g)
    assert _ulp_error(got, ref, dtype, g) <= ULP_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_backward_layouts_and_mismatched_gradient_strides(dtype):
    """channels_last x with a contiguous g: the wrapper copies g into x's
    strides (one count in ``g_copies``); the result keeps x's layout. An
    unaligned view takes the scalar path."""
    _card()
    x = torch.randn(2, 16, 9, 7, device='cuda').to(TORCH[dtype]).contiguous(
        memory_format=torch.channels_last)
    g = torch.randn(2, 16, 9, 7, device='cuda').to(TORCH[dtype])
    copies = mish.mish_backward_cuda.g_copies
    got = mish.mish_backward_cuda(x, g)
    assert mish.mish_backward_cuda.g_copies == copies + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, mish.mish_backward_reference(x, g),
                               atol=0, rtol=0)
    flat = torch.randn(4099, device='cuda').to(TORCH[dtype])[1:]
    gflat = torch.randn(4099, device='cuda').to(TORCH[dtype])[1:]
    torch.testing.assert_close(mish.mish_backward_cuda(flat, gflat),
                               mish.mish_backward_reference(flat, gflat),
                               atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize('layout', ['channels_last', 'contiguous'])
@pytest.mark.parametrize('dtype', ['float32', 'float16', 'bfloat16'])
def test_backward_reads_a_concat_slice_of_the_gradient_in_place(dtype,
                                                                 layout):
    """g a channel slice of a concat's gradient, as autograd hands it to a
    mish before ``torch.cat``: the kernel reads it through its pitch, with
    no copy, and matches the plain version on the same view."""
    _card()
    fmt = {'channels_last': torch.channels_last,
           'contiguous': torch.contiguous_format}[layout]
    x = _inputs(3 * 40 * 11 * 13, seed=7).reshape(3, 40, 11, 13)
    x = x.to('cuda', TORCH[dtype]).contiguous(memory_format=fmt)
    whole = torch.randn(3, 40 + 24 + 16, 11, 13, device='cuda')
    g = whole.to(TORCH[dtype]).contiguous(memory_format=fmt)[:, 24:64]
    assert mish._g_rows(x, g)[0] < x.numel()
    before = (mish.mish_backward_cuda.g_copies,
              mish.mish_backward_cuda.g_pitched)
    got = mish.mish_backward_cuda(x, g)
    assert (mish.mish_backward_cuda.g_copies,
            mish.mish_backward_cuda.g_pitched) == (before[0], before[1] + 1)
    assert got.is_contiguous(memory_format=fmt)
    torch.testing.assert_close(got, mish.mish_backward_reference(x, g),
                               atol=0, rtol=0, equal_nan=True)


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
