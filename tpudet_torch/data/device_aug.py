"""Mosaic, random affine, HSV jitter and normalize of a batch on the
device: counterpart of ``tpudet/data/device_aug.py``.

The host only reads and letterboxes tiles (``MosaicTileLoader``); this
module does the rest on the tiles' device, batched over the images:

- the 4-tile mosaic paste around the canvas center
  (``tpudet/data/pipelines.py:292-341``), as index arithmetic and one
  gather;
- the configs' affine chain (center-pad ``pad_to``, random-crop ``crop``,
  random scale 1 +/- ``scale_limit``, center-crop ``out``, flip) composed
  into one axis-aligned map per image and applied as a separable bilinear
  warp: two fp32 matrix products (``_separable_warp``);
- gt boxes through the same map, with the albumentations ``min_area`` /
  ``min_visibility`` filter and ``GtBBoxesFilter`` folded into the
  validity mask;
- HSV gain jitter in continuous math (``hsv_jitter``), then BGR -> RGB
  and ``(x - 114) / 255``.

The random draws are split from their application. ``sample_aug_params``
draws each image's crop offsets, scale, flip and HSV gains from a
``torch.Generator`` seeded with the image's ``aug_seed`` (on the host);
``device_mosaic_affine`` applies given parameters. tpudet draws the same
quantities from threefry keys folded from the same seeds, so the numbers
differ while their ranges and laws agree; its draws can be passed in
(``affine_params``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


class AffineParams(NamedTuple):
    """Axis-aligned map output -> canvas per image:
    ``x_c = (x_pre + cc) * inv_f + crop - pad``, with an optional
    horizontal flip in output space. Tensors are (B,) float32 (``flip``
    bool) on one device."""
    inv_f: torch.Tensor  # 1 / scale factor
    cc: torch.Tensor  # center-crop offset in scaled coords
    crop_x: torch.Tensor
    crop_y: torch.Tensor
    pad: float
    flip: torch.Tensor
    out: int

    def _per_image(self, t: torch.Tensor, like: torch.Tensor):
        return t.reshape((-1,) + (1,) * (like.dim() - 1))

    def out_to_canvas(self, xy_out: torch.Tensor) -> torch.Tensor:
        """(B, ..., 2) output coords -> canvas coords."""
        x, y = xy_out[..., 0], xy_out[..., 1]
        p = lambda t: self._per_image(t, x)  # noqa: E731
        x = torch.where(p(self.flip), self.out - 1.0 - x, x)
        xc = (x + p(self.cc)) * p(self.inv_f) + p(self.crop_x) - self.pad
        yc = (y + p(self.cc)) * p(self.inv_f) + p(self.crop_y) - self.pad
        return torch.stack([xc, yc], dim=-1)

    def canvas_to_out_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, N, 4) xyxy canvas -> output coords (flip handled)."""
        p = lambda t: self._per_image(t, boxes[..., 0])  # noqa: E731
        f = 1.0 / p(self.inv_f)

        def x_out(xc):
            x_pre = (xc + self.pad - p(self.crop_x)) * f - p(self.cc)
            return torch.where(p(self.flip), self.out - 1.0 - x_pre, x_pre)

        def y_out(yc):
            return (yc + self.pad - p(self.crop_y)) * f - p(self.cc)

        x1 = x_out(boxes[..., 0])
        x2 = x_out(boxes[..., 2])
        return torch.stack([torch.minimum(x1, x2), y_out(boxes[..., 1]),
                            torch.maximum(x1, x2), y_out(boxes[..., 3])],
                           dim=-1)


def affine_params(f, crop_x, crop_y, flip, canvas: int, pad_to: int,
                  crop: int, out: int) -> AffineParams:
    """The map of draws ``f`` (scale), ``crop_x``, ``crop_y``, ``flip``
    ((B,) each) on a ``canvas``-sized mosaic, as tpudet's
    ``sample_affine`` builds it in float32."""
    f = torch.as_tensor(f, dtype=torch.float32)
    pad = (max(pad_to, canvas) - canvas) // 2
    return AffineParams(
        inv_f=1.0 / f, cc=(crop * f - out) / 2.0,
        crop_x=torch.as_tensor(crop_x).to(torch.float32, copy=True),
        crop_y=torch.as_tensor(crop_y).to(torch.float32, copy=True),
        pad=float(pad), flip=torch.as_tensor(flip, dtype=torch.bool),
        out=out)


def sample_affine(generator: torch.Generator, canvas: int, pad_to: int,
                  crop: int, scale_limit: float, out: int) -> AffineParams:
    """One image's affine drawn from ``generator``: crop offsets uniform
    over ``[0, max(pad_to, canvas) - crop]``, scale ``1 + U(-scale_limit,
    scale_limit)``, flip with probability 1/2 (the draws of
    ``tpudet/data/device_aug.py:74-86``). Tensors of shape (1,)."""
    max_off = max(pad_to, canvas) - crop
    crop_x = torch.randint(0, max_off + 1, (1,), generator=generator)
    crop_y = torch.randint(0, max_off + 1, (1,), generator=generator)
    u = torch.rand(1, generator=generator)
    f = 1.0 + (u * (2 * scale_limit) - scale_limit)
    flip = torch.rand(1, generator=generator) < 0.5
    return affine_params(f, crop_x, crop_y, flip, canvas, pad_to, crop, out)


def sample_aug_params(aug_seed, canvas: int, pad_to: int, crop: int,
                      scale_limit: float, out: int, hue_ratio: float,
                      saturation_ratio: float, value_ratio: float
                      ) -> Tuple[AffineParams, torch.Tensor]:
    """Each image's affine and HSV gains from its ``aug_seed`` ((B,) host
    ints), drawn on the host: a ``torch.Generator`` seeded with the seed
    draws the affine (``sample_affine``), then three gains
    ``U(-1, 1) * ratio + 1`` (hue, saturation, value). Returns
    (AffineParams of (B,) CPU tensors, gains (B, 3))."""
    ratios = torch.tensor([hue_ratio, saturation_ratio, value_ratio])
    affs, gains = [], []
    for seed in np.asarray(aug_seed).reshape(-1).tolist():
        g = torch.Generator().manual_seed(int(seed))
        affs.append(sample_affine(g, canvas, pad_to, crop, scale_limit, out))
        gains.append((torch.rand(3, generator=g) * 2 - 1) * ratios + 1)
    aff = AffineParams(*[torch.cat(v) if isinstance(v[0], torch.Tensor)
                         else v[0] for v in zip(*affs)])
    return aff, torch.stack(gains)


def params_to(aff: AffineParams, device) -> AffineParams:
    """``aff`` with its tensors on ``device``."""
    return aff._replace(**{k: v.to(device) for k, v in aff._asdict().items()
                           if isinstance(v, torch.Tensor)})


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """fp32 matrix products in full fp32 on the card, whatever the
    process's TF32 setting: ``torch.backends.cuda.matmul.allow_tf32`` is
    False inside, and restored after. TF32 keeps 10 bits of the
    interpolation weights, ~0.1 uint8 level of error at 255. (The CPU has
    no TF32.)"""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _separable_warp(canvas: torch.Tensor, src_y: torch.Tensor,
                    src_x: torch.Tensor, pad_val: float) -> torch.Tensor:
    """Axis-aligned bilinear warp as two fp32 matrix products
    (``tpudet/data/device_aug.py:89-120``): ``out = Wy @ canvas @ Wx^T``
    with ``W[o, c] = max(0, 1 - |src(o) - c|)``; the uncovered fraction of
    each output pixel is filled with ``pad_val``.

    Args:
        canvas: (B, H, W, 3) float32.
        src_y: (B, out_h) canvas y of each output row.
        src_x: (B, out_w) canvas x of each output column.
    """
    b, h, w, c = canvas.shape
    cy = torch.arange(h, dtype=torch.float32, device=canvas.device)
    cx = torch.arange(w, dtype=torch.float32, device=canvas.device)
    wy = (1. - (src_y[..., None] - cy).abs()).clamp_min(0.)  # (B, oh, H)
    wx = (1. - (src_x[..., None] - cx).abs()).clamp_min(0.)  # (B, ow, W)
    oh, ow = wy.shape[1], wx.shape[1]
    with _ieee_fp32_matmul():
        # rows: (B, oh, W*3); then columns, one product per image over
        # (W, oh*3): (B, ow, oh*3)
        tmp = torch.matmul(wy, canvas.reshape(b, h, w * c))
        tmp = tmp.reshape(b, oh, w, c).permute(0, 2, 1, 3).reshape(
            b, w, oh * c)
        out = torch.matmul(wx, tmp).reshape(b, ow, oh, c).transpose(1, 2)
    # coverage-weighted pad fill (weights sum to 1 strictly inside)
    cov = (wy.sum(2)[:, :, None] * wx.sum(2)[:, None, :])[..., None]
    return out + (1. - cov.clamp(0., 1.)) * pad_val


def _bilinear_gather(canvas: torch.Tensor, src_xy: torch.Tensor,
                     pad_val: float) -> torch.Tensor:
    """canvas (H, W, 3) float; src_xy (h, w, 2); constant-border reads
    (``tpudet/data/device_aug.py:123-142``)."""
    h, w = canvas.shape[:2]
    x, y = src_xy[..., 0], src_xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]

    def read(xi, yi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi = xi.to(torch.int64).clamp(0, w - 1)
        yi = yi.to(torch.int64).clamp(0, h - 1)
        return torch.where(inside[..., None], canvas[yi, xi],
                           torch.tensor(pad_val, dtype=canvas.dtype))

    top = read(x0, y0) * (1 - fx) + read(x0 + 1, y0) * fx
    bot = read(x0, y0 + 1) * (1 - fx) + read(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def hsv_jitter(img_bgr: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """HSV gain jitter on (B, H, W, 3) float BGR in [0, 255] with (B, 3)
    gains (hue, saturation, value), in continuous math
    (``tpudet/data/device_aug.py:145-178``: OpenCV's hue range [0, 180),
    floor-mod wraps, the sector select in ``jnp.select`` order)."""
    g = gains.to(img_bgr)[:, None, None, :]
    b, gr, r = img_bgr[..., 0], img_bgr[..., 1], img_bgr[..., 2]
    maxc = torch.maximum(torch.maximum(r, gr), b)
    minc = torch.minimum(torch.minimum(r, gr), b)
    delta = maxc - minc
    v = maxc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-6), 0.) * 255.
    safe = delta.clamp_min(1e-6)
    h = torch.where(maxc == r, (gr - b) / safe,
                    torch.where(maxc == gr, 2.0 + (b - r) / safe,
                                4.0 + (r - gr) / safe))
    h = torch.remainder(h * 30.0, 180.0)

    h = torch.remainder(h * g[..., 0], 180.0)
    s = (s * g[..., 1]).clamp(0., 255.)
    v = (v * g[..., 2]).clamp(0., 255.)

    h6 = h / 30.0
    i = torch.remainder(torch.floor(h6).to(torch.int64), 6)
    f = h6 - torch.floor(h6)
    sn = s / 255.
    p = v * (1 - sn)
    q = v * (1 - sn * f)
    t = v * (1 - sn * (1 - f))
    sel = lambda *vals: torch.gather(  # noqa: E731
        torch.stack(vals, -1), -1, i[..., None])[..., 0]
    r2 = sel(v, q, p, p, t, v)
    g2 = sel(t, v, v, q, p, p)
    b2 = sel(p, p, t, v, v, q)
    return torch.stack([b2, g2, r2], dim=-1)


def _mosaic_canvas(tiles: torch.Tensor, tile_hw: torch.Tensor,
                   pad_val: float) -> torch.Tensor:
    """The (B, 2S, 2S, 3) float32 mosaic of (B, 4, S, S, 3) uint8 tiles:
    tile q's content (``tile_hw``) with its inner corner at the canvas
    center (``tpudet/data/device_aug.py:223-238``), ``pad_val``
    elsewhere. The canvas, seen as (B, quadrant row, row, quadrant
    column, column), reads each pixel from its quadrant's tile at a
    per-image offset: one gather with broadcast indices."""
    b, _, s = tiles.shape[:3]
    dev = tiles.device
    h, w = tile_hw[..., 0].long(), tile_hw[..., 1].long()  # (B, 4)
    half = torch.arange(2, device=dev)
    q = 2 * half[:, None, None, None] + half[None, None, :, None]
    hq, wq = h[:, q], w[:, q]  # (B, 2, 1, 2, 1)
    # the content's offset inside its quadrant: the left column and the
    # top row are anchored to the center
    ty = torch.arange(s, device=dev).view(1, 1, s, 1, 1) - torch.where(
        q < 2, s - hq, 0)
    tx = torch.arange(s, device=dev).view(1, 1, 1, 1, s) - torch.where(
        q % 2 == 0, s - wq, 0)
    inside = (ty >= 0) & (ty < hq) & (tx >= 0) & (tx < wq)
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    px = tiles[bi, q, ty.clamp(0, s - 1), tx.clamp(0, s - 1)]
    canvas = torch.where(inside[..., None], px.to(torch.float32), pad_val)
    return canvas.reshape(b, 2 * s, 2 * s, tiles.shape[-1])


def device_mosaic_affine(tiles: torch.Tensor,
                         tile_hw: torch.Tensor,
                         gt_bboxes: torch.Tensor,
                         gt_valid: torch.Tensor,
                         gt_labels: torch.Tensor,
                         aff: AffineParams,
                         gains: torch.Tensor,
                         pad_val: float = 114.,
                         min_area: float = 4.,
                         min_visibility: float = 0.2,
                         min_size: float = 2.,
                         max_aspect_ratio: float = 20.
                         ) -> Dict[str, torch.Tensor]:
    """Mosaic + affine + HSV + normalize for a batch, with given draws
    (``tpudet/data/device_aug.py:181-288``), on the tiles' device.

    Args:
        tiles: (B, 4, S, S, 3) uint8 BGR letterboxed tiles (content in
            ``tile_hw``).
        tile_hw: (B, 4, 2) (h, w) of each tile's content.
        gt_bboxes: (B, 4, G, 4) per-tile gt boxes (tile coords, xyxy).
        gt_valid: (B, 4, G) bool.
        gt_labels: (B, 4, G).
        aff: each image's affine onto the (2S, 2S) canvas (``out`` is the
            output size), tensors on the tiles' device.
        gains: (B, 3) HSV gains.

    Returns:
        dict(img (B, out, out, 3) float32 RGB normalized,
             gt_bboxes (B, 4G, 4), gt_labels (B, 4G), gt_valid (B, 4G)).
    """
    b, _, s = tiles.shape[:3]
    out_size = aff.out
    dev = tiles.device
    tile_hw = tile_hw.to(dev)
    canvas = _mosaic_canvas(tiles, tile_hw, pad_val)

    # the affine is axis-aligned and separable: source coordinates per
    # output row / column
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    src = aff.out_to_canvas(torch.stack([o, o], -1).expand(b, -1, -1))
    img = _separable_warp(canvas, src[..., 1], src[..., 0], pad_val)
    img = hsv_jitter(img, gains)

    # boxes: tile coords -> canvas coords -> output coords
    h, w = tile_hw[..., 0].float(), tile_hw[..., 1].float()  # (B, 4)
    q = torch.arange(4, device=dev)
    x1 = torch.where(q % 2 == 0, s - w, float(s))
    y1 = torch.where(q < 2, s - h, float(s))
    off = torch.stack([x1, y1, x1, y1], dim=-1)[:, :, None, :]
    cboxes = (gt_bboxes.to(dev, torch.float32) + off).reshape(b, -1, 4)
    cvalid = gt_valid.to(dev).reshape(b, -1)
    clabels = gt_labels.to(dev).reshape(b, -1)

    out_boxes = aff.canvas_to_out_boxes(cboxes)
    area0 = ((cboxes[..., 2] - cboxes[..., 0]) *
             (cboxes[..., 3] - cboxes[..., 1]) / float(4 * s * s))
    clipped = out_boxes.clamp(0., float(out_size))
    bw = clipped[..., 2] - clipped[..., 0]
    bh = clipped[..., 3] - clipped[..., 1]
    area = bw * bh
    vis = (area / float(out_size * out_size)) / area0.clamp_min(1e-12)
    ar = torch.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
    keep = (cvalid & (area >= min_area) & (vis >= min_visibility)
            & (bw > min_size) & (bh > min_size) & (ar < max_aspect_ratio))

    img = (img.flip(-1) - 114.0) / 255.0  # BGR->RGB, normalize
    return dict(img=img, gt_bboxes=clipped, gt_labels=clabels,
                gt_valid=keep)


class DeviceAug:
    """The ``data.device_aug`` settings of a config as one callable: a
    tile batch (``MosaicTileLoader``'s keys, tensors on the device but
    ``aug_seed`` on the host) -> the augmented batch
    (``device_mosaic_affine``), with the draws made by
    ``sample_aug_params``."""

    def __init__(self, out_size: int = 640, pad_to: int = 1920,
                 crop: int = 1280, scale_limit: float = 0.5,
                 pad_val: float = 114., min_area: float = 4.,
                 min_visibility: float = 0.2, min_size: float = 2.,
                 max_aspect_ratio: float = 20., hue_ratio: float = 0.015,
                 saturation_ratio: float = 0.7, value_ratio: float = 0.4):
        self.out_size, self.pad_to, self.crop = out_size, pad_to, crop
        self.scale_limit = scale_limit
        self.ratios = (hue_ratio, saturation_ratio, value_ratio)
        self.apply_kwargs = dict(pad_val=pad_val, min_area=min_area,
                                 min_visibility=min_visibility,
                                 min_size=min_size,
                                 max_aspect_ratio=max_aspect_ratio)

    def draw(self, aug_seed, tile_size: int
             ) -> Tuple[AffineParams, torch.Tensor]:
        return sample_aug_params(aug_seed, 2 * tile_size, self.pad_to,
                                 self.crop, self.scale_limit, self.out_size,
                                 *self.ratios)

    def __call__(self, batch: Dict) -> Dict[str, torch.Tensor]:
        tiles = batch['tiles']
        aff, gains = self.draw(batch['aug_seed'], tiles.shape[2])
        return device_mosaic_affine(
            tiles, batch['tile_hw'], batch['gt_bboxes'], batch['gt_valid'],
            batch['gt_labels'], params_to(aff, tiles.device),
            gains.to(tiles.device), **self.apply_kwargs)
