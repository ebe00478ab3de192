"""``tpudet_torch/ops/resize.resize_bilinear`` against ``jax.image.resize(
..., 'bilinear')`` (antialiased), on the CPU, at the cases the zoo's row
i meets: HTC's fused semantic head (P2 down 2x to the fusion level, P4-P6
up 2x, 4x, 8x), SCNet's 5-D feature relay (7 -> 14 on two inner axes),
PointRend's subdivision (2x on the last two axes), non-integer ratios of
the small odd sizes of the CPU tests, and a one-pixel axis.

Tolerances: fp32 within 2e-7 of the largest |value| (the weights within
one ulp: XLA sums a column's taps in an order of its own before it
divides by the sum; the contraction order of its einsum may differ too);
float64 (jax's x64, the weights computed in float64 as jax does) within
1e-15; bf16 (the weights cast to bf16, as jax casts them) within one bf16
ulp of the largest |value|. ``F.interpolate`` is not the same function on a 2x
downsample, which the last test shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpudet_torch.ops.resize import resize_bilinear, weight_matrix

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

CASES = {
    'down_2x': ((2, 3, 32, 24), (2, 3, 16, 12)),
    'up_2x': ((2, 3, 21, 21), (2, 3, 42, 42)),
    'up_4x': ((1, 4, 11, 9), (1, 4, 44, 36)),
    'up_8x': ((1, 2, 21, 21), (1, 2, 168, 168)),
    'odd_down': ((1, 3, 17, 13), (1, 3, 9, 7)),
    'odd_up': ((1, 3, 5, 3), (1, 3, 9, 7)),
    'mixed': ((2, 2, 7, 30), (2, 2, 12, 11)),
    'relay_5d': ((2, 3, 7, 7, 8), (2, 3, 14, 14, 8)),
    'subdivision': ((2, 5, 28, 28), (2, 5, 56, 56)),
    'one_pixel': ((1, 2, 1, 6), (1, 2, 4, 3)),
}


def _pair(name, dtype):
    src, dst = CASES[name]
    x = np.random.RandomState(sum(src)).randn(*src)
    return x.astype(dtype), dst


@pytest.mark.parametrize('name', sorted(CASES))
def test_resize_matches_jax_in_fp32(name):
    x, dst = _pair(name, np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, 'bilinear'))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == ref.shape == dst and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 2e-7 * np.abs(ref).max()


@pytest.mark.parametrize('name', ['down_2x', 'odd_down', 'up_8x',
                                  'relay_5d'])
def test_resize_matches_jax_in_float64(name):
    x, dst = _pair(name, np.float64)
    with jax.enable_x64(True):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, 'bilinear'))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert ref.dtype == got.dtype == np.float64
    assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()


@pytest.mark.parametrize('name', ['down_2x', 'up_8x', 'odd_up'])
def test_resize_matches_jax_in_bf16(name):
    x, dst = _pair(name, np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x, jnp.bfloat16), dst,
                                      'bilinear').astype(jnp.float32))
    got = resize_bilinear(torch.from_numpy(x).bfloat16(), dst)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= \
        2 ** -7 * np.abs(ref).max()


def test_weights_are_jaxs():
    from jax._src.image.scale import _fill_triangle_kernel, \
        compute_weight_mat
    for n_in, n_out in ((32, 16), (21, 168), (17, 9), (5, 9), (1, 4)):
        ref = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.,
                                            _fill_triangle_kernel, True))
        got = weight_matrix(n_in, n_out, torch.float32).numpy()
        np.testing.assert_allclose(got, ref, rtol=1.2e-7, atol=0)


def test_a_downsample_is_not_interpolates():
    """On a 2x downsample jax's triangle widens over four taps (an
    antialiased filter); ``F.interpolate``'s bilinear takes two."""
    x, dst = _pair('down_2x', np.float32)
    got = resize_bilinear(torch.from_numpy(x), dst)
    plain = F.interpolate(torch.from_numpy(x), size=dst[2:],
                          mode='bilinear', align_corners=False)
    assert (got - plain).abs().max() > 0.1
