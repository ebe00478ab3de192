"""The port's on-device augmentation (``tpudet_torch/data/device_aug.py``)
against tpudet's ``tpudet/data/device_aug.py``, on the CPU.

tpudet draws each image's crop offsets, scale, flip and HSV gains from
threefry keys folded from the image's seed; the port draws them from a
``torch.Generator``. The tests make tpudet's draws with jax, as its
``device_mosaic_affine`` makes them, and pass them to the port's
application (``affine_params``); the port's own draws are checked
against tpudet's ranges.

Tolerances (fp32): the affine maps' fields equal; mapped points and boxes
within 1e-3 px; warped images within 1e-4 of 255 (raw) or 1e-4
(normalized); gt validity equal except for boxes within 1e-4 (relative)
of a filter threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.data import device_aug as J
from tpudet_torch.data import device_aug as P

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

S, PAD_TO, CROP, OUT = 64, 192, 128, 64
RATIOS = (0.015, 0.7, 0.4)
AUG = dict(pad_to=PAD_TO, crop=CROP, scale_limit=0.5, pad_val=114.,
           min_area=4., min_visibility=0.2, min_size=2., max_aspect_ratio=20.,
           hue_ratio=RATIOS[0], saturation_ratio=RATIOS[1],
           value_ratio=RATIOS[2])
IMG_TOL, BOX_TOL, EDGE_TOL = 1e-4, 1e-3, 1e-4


def tpudet_draws(seeds, canvas=2 * S, scale_limit=0.5):
    """tpudet's per-image draws for signed int seeds, made as its
    ``device_mosaic_affine`` makes them: (f, crop_x, crop_y, flip, gains)
    as numpy."""
    max_off = max(PAD_TO, canvas) - CROP
    out = {k: [] for k in ('f', 'crop_x', 'crop_y', 'flip', 'gains')}
    for s in seeds:
        key = jax.random.fold_in(jax.random.PRNGKey(0), int(s))
        k_aff, k_hsv = jax.random.split(key)
        k1, k2, k3, k4 = jax.random.split(k_aff, 4)
        out['crop_x'].append(jax.random.randint(k1, (), 0, max_off + 1))
        out['crop_y'].append(jax.random.randint(k2, (), 0, max_off + 1))
        out['f'].append(1.0 + jax.random.uniform(
            k3, (), minval=-scale_limit, maxval=scale_limit))
        out['flip'].append(jax.random.bernoulli(k4))
        out['gains'].append(jax.random.uniform(
            k_hsv, (3,), minval=-1., maxval=1.) * jnp.asarray(RATIOS) + 1.)
    return {k: np.stack([np.asarray(v) for v in vs]) for k, vs in out.items()}


def port_params(d, canvas=2 * S):
    aff = P.affine_params(torch.from_numpy(d['f']),
                          torch.from_numpy(d['crop_x']),
                          torch.from_numpy(d['crop_y']),
                          torch.from_numpy(d['flip']), canvas, PAD_TO, CROP,
                          OUT)
    return aff, torch.from_numpy(d['gains'])


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_affine_params_equal_tpudet_sample_affine(seed):
    d = tpudet_draws([seed])
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                              seed))[0]
    ref = J.sample_affine(key, 2 * S, PAD_TO, CROP, 0.5, OUT)
    aff, _ = port_params(d)
    for k in ('inv_f', 'cc', 'crop_x', 'crop_y', 'flip'):
        np.testing.assert_array_equal(getattr(aff, k).numpy()[0],
                                      np.asarray(getattr(ref, k)), k)
    assert aff.pad == ref.pad and aff.out == ref.out

    rng = np.random.RandomState(seed)
    pts = rng.uniform(-10, OUT + 10, (1, 20, 2)).astype(np.float32)
    np.testing.assert_allclose(
        aff.out_to_canvas(torch.from_numpy(pts)).numpy()[0],
        np.asarray(ref.out_to_canvas(pts[0])), rtol=0, atol=BOX_TOL)
    xy = rng.uniform(0, 2 * S, (1, 15, 2, 2)).astype(np.float32)
    boxes = np.concatenate([xy.min(2), xy.max(2)], -1)
    np.testing.assert_allclose(
        aff.canvas_to_out_boxes(torch.from_numpy(boxes)).numpy()[0],
        np.asarray(ref.canvas_to_out_boxes(boxes[0])), rtol=0,
        atol=BOX_TOL)


@pytest.mark.parametrize('seed', [0, 1])
def test_separable_warp_matches_tpudet(seed):
    rng = np.random.RandomState(seed)
    canvas = rng.randint(0, 256, (2, 40, 56, 3)).astype(np.float32)
    src_y = rng.uniform(-3, 43, (2, 30)).astype(np.float32)
    src_x = rng.uniform(-3, 59, (2, 36)).astype(np.float32)
    got = P._separable_warp(torch.from_numpy(canvas), torch.from_numpy(src_y),
                            torch.from_numpy(src_x), 114.).numpy()
    for i in range(2):
        ref = np.asarray(J._separable_warp(canvas[i], src_y[i], src_x[i],
                                           114.))
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=255 * IMG_TOL)


def test_separable_warp_ignores_the_tf32_setting():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with P._ieee_fp32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_bilinear_gather_matches_tpudet():
    rng = np.random.RandomState(3)
    canvas = rng.randint(0, 256, (30, 40, 3)).astype(np.float32)
    src = rng.uniform(-4, 44, (12, 14, 2)).astype(np.float32)
    got = P._bilinear_gather(torch.from_numpy(canvas), torch.from_numpy(src),
                             114.).numpy()
    ref = np.asarray(J._bilinear_gather(canvas, src, 114.))
    np.testing.assert_allclose(got, ref, rtol=0, atol=255 * IMG_TOL)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_hsv_jitter_matches_tpudet(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (2, 24, 32, 3)).astype(np.float32)
    img[0, :4] = 0  # black: s = 0
    img[0, 4:8] = 200  # grey: ties of every max
    img[1, :4, :, 0] = img[1, :4, :, 2]  # b == r ties
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    gains = np.stack([np.asarray(jax.random.uniform(
        k, (3,), minval=-1., maxval=1.) * jnp.asarray(RATIOS) + 1.)
        for k in keys])
    got = P.hsv_jitter(torch.from_numpy(img), torch.from_numpy(gains))
    for i in range(2):
        ref = np.asarray(J.hsv_jitter(img[i], keys[i], *RATIOS))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=0,
                                   atol=255 * IMG_TOL)


def _tile_batch(b, seed, s=S, g=5):
    rng = np.random.RandomState(seed)
    tiles = np.zeros((b, 4, s, s, 3), np.uint8)
    hw = np.zeros((b, 4, 2), np.int32)
    boxes = np.zeros((b, 4, g, 4), np.float32)
    valid = np.zeros((b, 4, g), bool)
    for i in range(b):
        for q in range(4):
            h, w = rng.randint(s // 2, s + 1, 2)
            if (i + q) % 3 == 0:
                h = s  # a full-height tile
            hw[i, q] = h, w
            tiles[i, q, :h, :w] = rng.randint(0, 256, (h, w, 3))
            n = rng.randint(1, g + 1)
            xy = rng.uniform(0, [w - 4, h - 4], (n, 2))
            wh = rng.uniform(2, [w / 2, h / 2], (n, 2))
            boxes[i, q, :n] = np.concatenate(
                [xy, np.minimum(xy + wh, [w, h])], 1)
            valid[i, q, :n] = True
    labels = rng.randint(0, 80, (b, 4, g)).astype(np.int32)
    return tiles, hw, boxes, valid, labels


def _near_threshold(boxes_out, area0):
    """Boxes whose filter quantities lie within EDGE_TOL (relative) of a
    threshold."""
    w = boxes_out[..., 2] - boxes_out[..., 0]
    h = boxes_out[..., 3] - boxes_out[..., 1]
    area = w * h
    vis = area / (OUT * OUT) / np.maximum(area0, 1e-12)
    ar = np.maximum(w / (h + 1e-16), h / (w + 1e-16))
    near = lambda x, t: np.abs(x - t) <= EDGE_TOL * max(t, 1)  # noqa: E731
    return (near(area, 4.) | near(vis, 0.2) | near(w, 2.) | near(h, 2.)
            | near(ar, 20.))


@pytest.mark.parametrize('batch_seed', [0, 1, 2])
def test_device_mosaic_affine_with_tpudet_draws(batch_seed):
    tiles, hw, boxes, valid, labels = _tile_batch(4, batch_seed)
    seeds = np.random.RandomState(batch_seed + 50).randint(
        0, 2**31 - 1, 4).astype(np.int32)
    ref = jax.device_get(J.device_mosaic_affine(
        tiles, hw, boxes, valid, labels, jnp.asarray(seeds), out_size=OUT,
        **AUG))
    aff, gains = port_params(tpudet_draws(seeds))
    kw = {k: AUG[k] for k in ('pad_val', 'min_area', 'min_visibility',
                              'min_size', 'max_aspect_ratio')}
    got = P.device_mosaic_affine(
        torch.from_numpy(tiles), torch.from_numpy(hw),
        torch.from_numpy(boxes), torch.from_numpy(valid),
        torch.from_numpy(labels), aff, gains, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    assert got['img'].shape == (4, OUT, OUT, 3)
    np.testing.assert_allclose(got['img'], ref['img'], rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(got['gt_bboxes'], ref['gt_bboxes'], rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_array_equal(got['gt_labels'], ref['gt_labels'])
    off = got['gt_valid'] != ref['gt_valid']
    x1 = np.where(np.arange(4) % 2 == 0, S - hw[..., 1], S)
    y1 = np.where(np.arange(4) < 2, S - hw[..., 0], S)
    cb = boxes + np.stack([x1, y1, x1, y1], -1)[:, :, None].astype(
        np.float32)
    area0 = ((cb[..., 2] - cb[..., 0]) * (cb[..., 3] - cb[..., 1])
             / (4 * S * S)).reshape(4, -1)
    assert not (off & ~_near_threshold(ref['gt_bboxes'], area0)).any()
    assert 0 < ref['gt_valid'].sum() < valid.sum()


def test_port_draws_fall_in_tpudet_ranges():
    seeds = np.arange(400, dtype=np.int32) * 7919
    aff, gains = P.sample_aug_params(seeds, 2 * S, PAD_TO, CROP, 0.5, OUT,
                                     *RATIOS)
    again, gains2 = P.sample_aug_params(seeds, 2 * S, PAD_TO, CROP, 0.5,
                                        OUT, *RATIOS)
    torch.testing.assert_close(aff.inv_f, again.inv_f, rtol=0, atol=0)
    torch.testing.assert_close(gains, gains2, rtol=0, atol=0)
    d = tpudet_draws(seeds[:50])
    max_off = PAD_TO - CROP
    for crop in (aff.crop_x, aff.crop_y):
        assert crop.min() >= 0 and crop.max() <= max_off
        assert crop.eq(crop.round()).all()
        assert len(set(crop.tolist())) > max_off // 2
    f = 1.0 / aff.inv_f
    assert f.min() >= 0.5 - 1e-6 and f.max() < 1.5 + 1e-6
    assert 0.5 - 1e-6 <= d['f'].min() and d['f'].max() < 1.5
    assert 0.35 < aff.flip.float().mean() < 0.65
    r = torch.tensor(RATIOS)
    assert ((gains - 1).abs() <= r + 1e-6).all()
    assert (np.abs(d['gains'] - 1) <= np.asarray(RATIOS) + 1e-6).all()
    assert aff.pad == (PAD_TO - 2 * S) // 2


def test_device_aug_on_a_tile_batch():
    """``DeviceAug``: draws from the batch's seeds, applies them."""
    tiles, hw, boxes, valid, labels = _tile_batch(3, 9)
    aug = P.DeviceAug(out_size=OUT, **AUG)
    batch = dict(tiles=torch.from_numpy(tiles), tile_hw=torch.from_numpy(hw),
                 gt_bboxes=torch.from_numpy(boxes),
                 gt_valid=torch.from_numpy(valid),
                 gt_labels=torch.from_numpy(labels),
                 aug_seed=torch.tensor([1, 2, 3], dtype=torch.int32))
    out = aug(batch)
    assert out['img'].shape == (3, OUT, OUT, 3)
    assert out['gt_bboxes'].shape == (3, 20, 4)
    assert torch.isfinite(out['img']).all()
    assert out['img'].min() >= -114 / 255 - 1e-6 and \
        out['img'].max() <= 141 / 255 + 1e-6
    again = aug(batch)
    torch.testing.assert_close(out['img'], again['img'], rtol=0, atol=0)
