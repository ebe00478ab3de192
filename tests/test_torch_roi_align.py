"""The port's RoIAlign (``tpudet_torch/ops/roi_align.py``) against tpudet's
(``tpudet/ops/roi_align.py``), on the CPU in fp32, from numpy seeds.

Tolerances:

- ``roi_align`` and ``multilevel_roi_align``: atol 1e-5 (the port sums the
  16 weighted corner reads of a bin in another order); rois partly and
  wholly outside the map, tiny (under the 1e-3 clamp), on every level,
  on the level boundaries (sides of exactly 56 * 2^k px) and invalid;
- the level codes: equal, on random rois and on the boundaries;
- the batched form, each roi pooled at its own level only: equal to
  tpudet's per-image vmap at atol 1e-5;
- the gradient with respect to the features against ``jax.grad``: rtol
  1e-4, atol 1e-6 of each level's largest |gradient| (each element sums
  the cotangents of up to hundreds of samples; the two scatter-adds sum
  them in other orders, ~1e-6 of the largest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.ops import roi_align as jra
from tpudet_torch.ops import roi_align as tra

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

STRIDES = (4, 8, 16, 32)
IMG = 128
ATOL = 1e-5


def _rois(rng, n, size=IMG):
    """Random xyxy rois: sides from 0.5 px to the image, centres anywhere
    in [-0.25, 1.25] of the image (so some lie partly or wholly outside),
    a few of zero width, a few tiny."""
    c = rng.uniform(-0.25 * size, 1.25 * size, (n, 2))
    wh = np.exp(rng.uniform(np.log(0.5), np.log(size), (n, 2)))
    wh[:3, 0] = 0.0
    wh[3:6] = rng.uniform(1e-5, 1e-3, (3, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _boundary_rois(rng):
    """Squares of side exactly 56 * 2^k (sqrt(area) / 56 a power of two),
    and one float32 step either side of it."""
    out = []
    for k in range(-2, 4):
        for side in (56.0 * 2**k, np.nextafter(np.float32(56.0 * 2**k), 0),
                     np.nextafter(np.float32(56.0 * 2**k), np.inf)):
            x, y = rng.uniform(0, IMG / 2, 2)
            out.append([x, y, x + side, y + side])
    return np.asarray(out, np.float32)


def _feats(rng, b=None, c=8, size=IMG):
    shapes = [(size // s, size // s, c) for s in STRIDES]
    lead = () if b is None else (b,)
    return [rng.randn(*lead, *s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize('scale', [1.0, 0.25, 1 / 16])
def test_roi_align_matches_tpudet(scale):
    rng = np.random.RandomState(0)
    feat = rng.randn(20, 17, 5).astype(np.float32)
    rois = _rois(rng, 60, size=20 / scale)
    ref = jra.roi_align(jnp.asarray(feat), jnp.asarray(rois), out_size=7,
                        spatial_scale=scale, sampling_ratio=2)
    got = tra.roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                        out_size=7, spatial_scale=scale, sampling_ratio=2)
    assert tuple(got.shape) == (60, 7, 7, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_roi_align_other_sizes_and_ratios():
    rng = np.random.RandomState(1)
    feat = rng.randn(12, 12, 3).astype(np.float32)
    rois = _rois(rng, 20, size=12)
    for out_size, ratio in ((14, 2), (5, 3), (1, 1)):
        ref = jra.roi_align(jnp.asarray(feat), jnp.asarray(rois),
                            out_size=out_size, sampling_ratio=ratio)
        got = tra.roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                            out_size=out_size, sampling_ratio=ratio)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _jax_levels(rois):
    areas = jnp.maximum((rois[:, 2] - rois[:, 0]) *
                        (rois[:, 3] - rois[:, 1]), 1e-6)
    target = jnp.floor(jnp.log2(jnp.sqrt(areas) / 56 + 1e-6))
    return np.asarray(jnp.clip(target, 0, 3).astype(jnp.int32))


def test_level_codes_equal_tpudets():
    rng = np.random.RandomState(2)
    rois = np.concatenate([_rois(rng, 4000, size=1344),
                           _boundary_rois(rng)])
    got = tra.roi_levels(torch.from_numpy(rois), 4).numpy()
    np.testing.assert_array_equal(got, _jax_levels(jnp.asarray(rois)))
    assert set(got.tolist()) == {0, 1, 2, 3}


def test_multilevel_roi_align_matches_tpudet():
    rng = np.random.RandomState(3)
    feats = _feats(rng)
    rois = np.concatenate([_rois(rng, 80), _boundary_rois(rng)])
    valid = rng.rand(len(rois)) > 0.2
    ref = jra.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                   jnp.asarray(rois), jnp.asarray(valid))
    got = tra.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                   torch.from_numpy(rois),
                                   torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert not got.numpy()[~valid].any()
    levels = tra.roi_levels(torch.from_numpy(rois), 4).numpy()
    assert set(levels[valid].tolist()) == {0, 1, 2, 3}


def test_batched_form_matches_tpudets_vmap():
    """The batched gather (each roi at its own level, per-image row
    offsets) against tpudet's per-image vmap over all levels."""
    rng = np.random.RandomState(4)
    feats = _feats(rng, b=3)
    rois = np.stack([_rois(rng, 50) for _ in range(3)])
    valid = rng.rand(3, 50) > 0.3
    ref = jax.vmap(lambda f, r, v: jra.multilevel_roi_align(f, r, v))(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
        jnp.asarray(valid))
    got = tra.batched_multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        torch.from_numpy(valid))
    assert tuple(got.shape) == (3, 50, 7, 7, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_an_nhwc_view_of_a_channels_last_map_pools_alike():
    rng = np.random.RandomState(5)
    feats = _feats(rng, b=2)
    rois = torch.from_numpy(np.stack([_rois(rng, 30) for _ in range(2)]))
    valid = torch.ones(2, 30, dtype=torch.bool)
    plain = tra.batched_multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], rois, valid)
    views = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for f in feats]
    np.testing.assert_array_equal(
        tra.batched_multilevel_roi_align(views, rois, valid).numpy(),
        plain.numpy())


def test_feature_gradient_matches_jax_grad():
    rng = np.random.RandomState(6)
    feats = _feats(rng, b=2, c=4)
    rois = np.stack([np.concatenate([_rois(rng, 30), _boundary_rois(rng)])
                     for _ in range(2)])
    valid = rng.rand(*rois.shape[:2]) > 0.2
    cot = rng.randn(*rois.shape[:2], 7, 7, 4).astype(np.float32)

    def jax_loss(fs):
        out = jax.vmap(lambda f, r, v: jra.multilevel_roi_align(f, r, v))(
            fs, jnp.asarray(rois), jnp.asarray(valid))
        return jnp.sum(out * cot)

    ref = jax.grad(jax_loss)(tuple(jnp.asarray(f) for f in feats))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = tra.batched_multilevel_roi_align(tf, torch.from_numpy(rois),
                                           torch.from_numpy(valid))
    (out * torch.from_numpy(cot)).sum().backward()
    for t, r in zip(tf, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-6 * np.abs(r).max())
