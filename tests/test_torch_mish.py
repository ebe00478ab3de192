"""Mish: tpudet_torch's plain versions against tpudet on the CPU.

tpudet's Pallas kernel (``mish_pallas``) runs only on a TPU and has no
interpret switch, so it is held here through its function,
``tpudet.ops.mish.mish_reference``, and through the body of
``_mish_fwd_kernel``. The port's CUDA kernel is held against its plain
version on the card by ``test_torch_mish_kernel.py``.

The port computes the one-exp rational form ``x u(u+2) / (u(u+2) + 2)``,
``u = e^min(x, 20)``, in fp32; tpudet's fp32 code the literal chain
``x tanh(softplus(x))``. Tolerances: fp32 atol 1e-6 plus 2 ulp relative
(rtol 2.4e-7: the two forms, and XLA's and PyTorch's CPU approximations of
exp, tanh and log1p, differ by a few fp32 ulp); fp16 and bf16 within 1 ulp
of the output type (both sides round once from fp32); against an fp64
truth within 6 fp32 ulp where ``u`` is a normal number (x >= -87.3; the
form measured 4.3 here) and, where ``u`` is subnormal, within ``|x| + 1``
units of 2^-149 (u's own grid); bf16 rational form within test_mish.py's
class (relative error < 0.04 against fp32); tails exact.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpudet.ops.mish import _mish_fwd_kernel
from tpudet.ops.mish import mish as jax_mish
from tpudet.ops.mish import mish_reference as jax_mish_reference
from tpudet_torch.ops import mish as tmish

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

TORCH = {'float32': torch.float32, 'float16': torch.float16,
         'bfloat16': torch.bfloat16}
NUMPY = {'float32': np.float32, 'float16': np.float16,
         'bfloat16': ml_dtypes.bfloat16}
MANTISSA = {'float32': 23, 'float16': 10, 'bfloat16': 7}
MIN_EXP = {'float32': -126, 'float16': -14, 'bfloat16': -126}
# XLA's CPU code flushes fp32 denormals to zero (mish(-88) -> -0.0, where
# PyTorch keeps -5.3e-37): outputs below 2^-100 are held in ulps of 2^-100
TINY = 2.0**-100


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([
        np.linspace(-30, 30, 4001), rng.randn(4096) * 4,
        [0., -0., 8., -8., 20., -20., 88., -88., 1e4, -1e4]]).astype(
            np.float32)


def ulp_error(got, ref, dtype):
    """max |got - ref| in ulps of ``dtype`` at ``ref``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), max(2.0**MIN_EXP[dtype], TINY))
    ulp = 2.0 ** (np.floor(np.log2(mag)) - MANTISSA[dtype])
    return float((np.abs(got - ref) / ulp).max())


def _jax(fn, x, dtype):
    out = fn(jnp.asarray(x.astype(NUMPY[dtype])))
    return np.asarray(out.astype(jnp.float32))


def _torch(fn, x, dtype):
    return fn(torch.from_numpy(x).to(TORCH[dtype])).float().numpy()


def _kernel_body(x, dtype):
    """tpudet's ``_mish_fwd_kernel`` run as plain code on the CPU."""
    out = np.zeros(x.shape, NUMPY[dtype])
    _mish_fwd_kernel(jnp.asarray(x.astype(NUMPY[dtype])), out)
    return out.astype(np.float32)


def _truth(x):
    """Mish in fp64 of fp32 inputs."""
    x64 = torch.from_numpy(x).double()
    return (x64 * torch.tanh(torch.nn.functional.softplus(x64))).numpy()


# either side of the threshold (20), and the neighbourhood of mish's zero
# of slope (x ~ -1.1924)
EDGES = np.array([19.99, 20., 20.01, 1e4, -19.99, -20., -20.01,
                  *np.linspace(-1.25, -1.14, 23)], np.float32)


def test_reference_fp32_matches_tpudet():
    x = np.concatenate([_inputs(), EDGES])
    np.testing.assert_allclose(_torch(tmish.mish_reference, x, 'float32'),
                               _jax(jax_mish_reference, x, 'float32'),
                               atol=1e-6, rtol=2.4e-7)


def test_reference_fp32_matches_the_tpu_kernel_body():
    x = np.concatenate([_inputs(4), EDGES])
    np.testing.assert_allclose(_torch(tmish.mish_reference, x, 'float32'),
                               _kernel_body(x, 'float32'), atol=1e-6,
                               rtol=2.4e-7)


@pytest.mark.parametrize('dtype', ['float16', 'bfloat16'])
def test_reference_low_precision_within_one_ulp(dtype):
    x = np.concatenate([_inputs(1), EDGES])
    got = _torch(tmish.mish_reference, x, dtype)
    ref = _jax(jax_mish_reference, x, dtype)
    assert ulp_error(got, ref, dtype) <= 1


@pytest.mark.parametrize('dtype', ['float16', 'bfloat16'])
def test_reference_low_precision_matches_the_tpu_kernel_body(dtype):
    x = np.concatenate([_inputs(6), EDGES])
    got = _torch(tmish.mish_reference, x, dtype)
    assert ulp_error(got, _kernel_body(x, dtype), dtype) <= 1


def test_threshold_returns_x():
    """From x = 20 on the output is x itself, in every dtype; just below,
    the rational form is within 1 fp32 ulp of x, as tpudet's chain is."""
    x = np.array([20., 20.01, 21., 88., 1e4, 3e38], np.float32)
    for dtype in TORCH:
        xs = torch.from_numpy(x).to(TORCH[dtype])
        assert torch.equal(tmish.mish_reference(xs), xs)
    below = np.array([19.99, 19.5], np.float32)
    np.testing.assert_allclose(_torch(tmish.mish_reference, below, 'float32'),
                               _truth(below), rtol=2.0**-23, atol=0)


def test_against_fp64_truth_where_u_is_normal():
    rng = np.random.RandomState(5)
    x = np.concatenate([np.linspace(-87.3, 30, 200001), rng.randn(50000) * 4,
                        EDGES]).astype(np.float32)
    got = _torch(tmish.mish_reference, x, 'float32')
    assert ulp_error(got, _truth(x), 'float32') <= 6


def test_subnormal_u_range_against_fp64_truth():
    """x in [-104, -87]: u = e^x is subnormal (or 0 below -103.97), its
    grid is 2^-149 apart, and y = x u keeps that absolute error times
    |x|. Nothing is flushed to zero: mish(-88) = -5.3e-37."""
    x = np.linspace(-104, -87, 20001).astype(np.float32)
    got = _torch(tmish.mish_reference, x, 'float32').astype(np.float64)
    err = np.abs(got - _truth(x)) / 2.0**-149
    assert (err <= np.abs(x) + 1).all(), err.max()
    assert (got[x >= -103] < 0).all()
    assert float(tmish.mish_reference(torch.tensor([-88.]))) < -5e-37


@pytest.mark.parametrize('dtype', ['float32', 'float16'])
def test_mish_dtype_rules_match_tpudet(dtype):
    """fp32 and fp16 follow the literal fp32 chain, as in tpudet."""
    x = _inputs(2)
    got = _torch(tmish.mish, x, dtype)
    ref = _jax(jax_mish, x, dtype)
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=2.4e-7)
    else:
        assert ulp_error(got, ref, dtype) <= 1


def test_mish_bf16_rational_form():
    """bf16 computes tpudet's one-exp rational form: within test_mish.py's
    error class against fp32, and close to tpudet's own bf16 result (the
    two frameworks round the intermediate products at other places)."""
    x = np.linspace(-90, 90, 40001).astype(np.float32)
    got = _torch(tmish.mish, x, 'bfloat16')
    ref32 = _jax(jax_mish_reference, x, 'float32')
    assert np.isfinite(got).all()
    err = (np.abs(got - ref32) / np.maximum(np.abs(ref32), 1e-3)).max()
    assert err < 0.04, err
    ref16 = _jax(jax_mish, x, 'bfloat16')
    # relative to max(|ref|, 1e-3) as above: near 0 XLA's CPU code flushes
    # fp32 denormals to zero, so ulps of tiny outputs say nothing
    diff = (np.abs(got - ref16) / np.maximum(np.abs(ref16), 1e-3)).max()
    assert diff <= 2.0**-6, diff  # 4 ulp of bf16's 8-bit significand


def test_tails_exact():
    big = torch.tensor([50., 300.], dtype=torch.bfloat16)
    assert tmish.mish(big).float().tolist() == [50., 300.]
    assert float(tmish.mish(torch.tensor([-300.], dtype=torch.bfloat16))) == 0
    # not -88: exp(-88) is an fp32 denormal, which XLA's CPU code flushes
    # to zero (mish -> -0.0) while the port keeps it (mish -> -5.3e-37)
    tails = np.array([88., -60., 1e4, -1e4, 30., -30.], np.float32)
    for dtype in ('float32', 'bfloat16'):
        np.testing.assert_array_equal(
            _torch(tmish.mish_reference, tails, dtype),
            _jax(jax_mish_reference, tails, dtype))


def test_infinities():
    """+inf maps to +inf and -inf to 0, the limit; tpudet's literal
    product gives NaN at -inf, the port's kernel and plain version both
    give 0."""
    x = torch.tensor([float('inf'), float('-inf'), float('nan')])
    for dtype in TORCH.values():
        y = tmish.mish_reference(x.to(dtype)).float()
        assert y[0] == float('inf') and y[1] == 0 and torch.isnan(y[2])


def test_wrapper_on_cpu_is_the_plain_version_and_does_not_count():
    x = torch.from_numpy(_inputs(3)).reshape(1, -1)
    before = tmish.mish_cuda.launches
    for dtype in TORCH.values():
        xd = x.to(dtype)
        assert torch.equal(tmish.mish_cuda(xd), tmish.mish_reference(xd))
    assert tmish.mish_cuda.launches == before
