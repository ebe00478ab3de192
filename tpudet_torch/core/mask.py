"""Masks: port of ``tpudet/core/mask.py`` without cv2.

tpudet keeps each gt mask in its own box frame (a (G, S, S) float tensor an
image, rasterized once; transforms move the box, not the frame) and, at
test time, pastes each detection's 28 x 28 probabilities into the image and
encodes it as an uncompressed COCO RLE. Three of its calls are cv2's, which
the card's machine does not have; the port computes the same pixels itself:

- ``fill_poly``: ``cv2.fillPoly(mask, pts, 1)`` (8-connected, no shift)
  bit for bit: the Bresenham outline of every edge (clipped to the frame
  as cv2 clips it) and cv2's scanline fill of the edge collection in its
  16.16 fixed point, even-odd across all the polygons of the call. The
  edge table is made on the host (a few rows a polygon); the rows and the
  outline are torch ops on the requested device. The rules are OpenCV
  5.0.0's, against which the tests hold every pixel;
- ``paste_masks``: ``cv2.resize(prob, (w, h), INTER_LINEAR)`` on float32
  for every detection of a batch at once, on the probabilities' device:
  cv2's taps (computed in double), its horizontal pass then its vertical
  one, each ``a + (b - a) * f`` rounded once as cv2's fused multiply-add
  rounds it; thresholded with ``> thr`` inside each box's integer window.
  ``paste_mask_probs`` is the same arithmetic in numpy, one detection at
  a time, with tpudet's signature;
- ``encode_rle_batch``: the column-major run boundaries of a batch of
  masks found on their device; only the boundaries cross to the host.

``mask_iou_matrix`` computes tpudet's IoU (COCO's crowd rule) from the
runs, never from decoded bitmaps.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


# ---------------------------------------------------------------------------
# polygon fill (cv2.fillPoly, lineType 8, shift 0)
# ---------------------------------------------------------------------------

def _clip_line(w: int, h: int, x1, y1, x2, y2):
    """cv2's ``clipLine`` on int64 endpoints (elementwise over arrays):
    the ends moved onto the frame's border, in double arithmetic truncated
    to integers, in cv2's order. Returns (x1, y1, x2, y2, inside)."""
    x1, y1, x2, y2 = (np.array(v, np.int64) for v in (x1, y1, x2, y2))
    right, bottom = w - 1, h - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4 +
                (y > bottom) * 8).astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    with np.errstate(divide='ignore', invalid='ignore'):
        m = todo & ((c1 & 12) != 0)
        a = np.where(c1 < 8, 0, bottom)
        step = ((a - y1).astype(np.float64) * (x2 - x1) / (y2 - y1))
        x1 = np.where(m, x1 + np.trunc(np.where(m, step, 0)).astype(np.int64),
                      x1)
        y1 = np.where(m, a, y1)
        c1 = np.where(m, (x1 < 0) + (x1 > right) * 2, c1)
        m = todo & ((c2 & 12) != 0)
        a = np.where(c2 < 8, 0, bottom)
        step = ((a - y2).astype(np.float64) * (x2 - x1) / (y2 - y1))
        x2 = np.where(m, x2 + np.trunc(np.where(m, step, 0)).astype(np.int64),
                      x2)
        y2 = np.where(m, a, y2)
        c2 = np.where(m, (x2 < 0) + (x2 > right) * 2, c2)
        todo = todo & ((c1 & c2) == 0) & ((c1 | c2) != 0)
        m = todo & (c1 != 0)
        a = np.where(c1 == 1, 0, right)
        step = ((a - x1).astype(np.float64) * (y2 - y1) / (x2 - x1))
        y1 = np.where(m, y1 + np.trunc(np.where(m, step, 0)).astype(np.int64),
                      y1)
        x1 = np.where(m, a, x1)
        c1 = np.where(m, 0, c1)
        m = todo & (c2 != 0)
        a = np.where(c2 == 1, 0, right)
        step = ((a - x2).astype(np.float64) * (y2 - y1) / (x2 - x1))
        y2 = np.where(m, y2 + np.trunc(np.where(m, step, 0)).astype(np.int64),
                      y2)
        x2 = np.where(m, a, x2)
        c2 = np.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def _edge_table(polys: Sequence[np.ndarray], w: int, h: int):
    """cv2's ``CollectPolyEdges`` for the polygons of one call: the
    outline segments (pixel endpoints, drawn whatever their slope) and the
    fill edges (``y0 < y1``, ``x`` at ``y0`` and ``dx`` a row in 16.16
    fixed point). A segment that leaves the frame is clipped as cv2 clips
    it: its fill edge runs between the clipped ends' x, on the clipped
    rows unless clipping left both ends on one row, and is extended to
    its own rows at that slope."""
    p0s, p1s = [], []
    for p in polys:
        p = np.asarray(p, np.int64).reshape(-1, 2)
        if len(p):
            p0s.append(np.roll(p, 1, axis=0))
            p1s.append(p)
    if not p0s:
        empty = np.zeros(0, np.int64)
        return (empty,) * 4, (empty,) * 4
    p0, p1 = np.concatenate(p0s), np.concatenate(p1s)
    pt0x, pt1x = p0[:, 0] << XY_SHIFT, p1[:, 0] << XY_SHIFT
    pt0y, pt1y = p0[:, 1], p1[:, 1]
    t0x, t1x = p0[:, 0], p1[:, 0]
    lines = (t0x, pt0y, t1x, pt1y)

    outside = ((t0x < 0) | (t0x >= w) | (t1x < 0) | (t1x >= w) |
               (pt0y < 0) | (pt0y >= h) | (pt1y < 0) | (pt1y >= h))
    cx0, cy0, cx1, cy1, _ = _clip_line(w, h, t0x, pt0y, t1x, pt1y)
    moved = outside & (cy0 != cy1)
    pt0cx = np.where(outside, cx0 << XY_SHIFT, pt0x)
    pt1cx = np.where(outside, cx1 << XY_SHIFT, pt1x)
    pt0cy = np.where(moved, cy0, pt0y)
    pt1cy = np.where(moved, cy1, pt1y)

    keep = pt0y != pt1y
    pt0cx, pt1cx, pt0cy, pt1cy = (v[keep] for v in (pt0cx, pt1cx, pt0cy,
                                                    pt1cy))
    pt0y, pt1y = pt0y[keep], pt1y[keep]
    num, den = pt1cx - pt0cx, pt1cy - pt0cy
    dx = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))  # C's /
    down = pt0y < pt1y
    y0 = np.where(down, pt0y, pt1y)
    y1 = np.where(down, pt1y, pt0y)
    x = np.where(down, pt0cx + (pt0y - pt0cy) * dx,
                 pt1cx + (pt1y - pt1cy) * dx)
    return lines, (y0, y1, x, dx)


def _draw_lines(mask: torch.Tensor, group: np.ndarray, lines) -> None:
    """cv2's 8-connected ``Line`` (a ``LineIterator`` drawn left to right,
    clipped to the frame) of every segment, into ``mask[group]``."""
    _, h, w = mask.shape
    x1, y1, x2, y2, inside = _clip_line(w, h, *lines)
    x1, y1, x2, y2, group = (v[inside] for v in (x1, y1, x2, y2, group))
    if not len(x1):
        return
    swap = x2 < x1  # left to right
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vert = dy > dx
    major, minor = np.maximum(dx, dy), np.minimum(dx, dy)
    dev = mask.device
    t = lambda v: torch.as_tensor(v, device=dev)  # noqa: E731
    count = t(major + 1)
    seg = torch.repeat_interleave(torch.arange(len(x1), device=dev), count)
    start = torch.cumsum(count, 0) - count
    k = torch.arange(int(major.sum() + len(major)), device=dev) - start[seg]
    major_t, minor_t = t(major)[seg], t(minor)[seg]
    # Bresenham's minor steps after k major ones (the error starts at
    # major - 2 minor and steps when negative): floor((2 minor k + major
    # - 1) / (2 major))
    m = torch.div(torch.clamp_min(2 * minor_t * k + major_t - 1, 0),
                  torch.clamp_min(2 * major_t, 1), rounding_mode='floor')
    vert_t = t(vert)[seg]
    xs = t(x1)[seg] + torch.where(vert_t, m, k)
    ys = t(y1)[seg] + t(sy)[seg] * torch.where(vert_t, k, m)
    mask[t(group)[seg], ys, xs] = 1


def _fill_edges(mask: torch.Tensor, group: np.ndarray, edges) -> None:
    """cv2's ``FillEdgeCollection`` into ``mask[group]``: on each row, the
    active edges of a group (``y0 <= y < y1``) at ``x + (y - y0) dx``,
    sorted and filled pairwise from ``ceil(x_a)`` to ``floor(x_b)``
    (even-odd over the group's polygons), clipped to the row."""
    n_groups, h, w = mask.shape
    y0, y1, x, dx = edges
    if not len(y0):
        return
    # one row of edges a group, padded with edges that are never active
    order = np.argsort(group, kind='stable')
    group, y0, y1, x, dx = (v[order] for v in (group, y0, y1, x, dx))
    counts = np.bincount(group, minlength=n_groups)
    slot = np.arange(len(group)) - (np.cumsum(counts) - counts)[group]
    width = int(counts.max())
    dev = mask.device
    table = np.zeros((4, n_groups, width), np.int64)
    for i, v in enumerate((y0, y1, x, dx)):
        table[i, group, slot] = v
    y0, y1, x, dx = torch.as_tensor(table, device=dev)[:, :, None]
    rows = torch.arange(h, device=dev)[None, :, None]
    active = (y0 <= rows) & (rows < y1)
    xs = x + (rows - y0) * dx
    big = torch.iinfo(torch.int64).max
    xs = torch.sort(torch.where(active, xs, big), dim=2).values
    n = width // 2 * 2
    a = torch.div(xs[..., 0:n:2] + (XY_ONE - 1), XY_ONE, rounding_mode='floor')
    b = torch.div(xs[..., 1:n:2], XY_ONE, rounding_mode='floor')
    pair = (xs[..., 1:n:2] != big) & (a < w) & (b >= 0)
    a = a.clamp(0, w - 1)
    b = b.clamp(0, w - 1)
    # +1 at each span's first pixel, -1 after its last, summed along the
    # row (an empty span, ceil(x_a) = floor(x_b) + 1, adds nothing)
    marks = torch.zeros((n_groups, h, w + 1), dtype=torch.int32, device=dev)
    ones = pair.to(torch.int32)
    marks.scatter_add_(2, torch.where(pair, a, w), ones)
    marks.scatter_add_(2, torch.where(pair, b + 1, w), -ones)
    mask |= (torch.cumsum(marks[..., :w], 2) > 0).to(mask.dtype)


def fill_polys(groups: Sequence[Sequence[np.ndarray]], height: int,
               width: int, device: Union[str, torch.device] = 'cpu'
               ) -> torch.Tensor:
    """One ``cv2.fillPoly(zeros((height, width), uint8), polys, 1)`` for
    each group of polygons (int (N, 2) point arrays, a group's in one call,
    so that their overlaps cancel, even-odd), as a (len(groups), height,
    width) uint8 tensor on ``device``."""
    mask = torch.zeros((len(groups), height, width), dtype=torch.uint8,
                       device=torch.device(device))
    if height <= 0 or width <= 0 or not len(groups):
        return mask
    tables = [_edge_table(polys, width, height) for polys in groups]
    line_group = np.concatenate([np.full(len(t[0][0]), g, np.int64)
                                 for g, t in enumerate(tables)])
    edge_group = np.concatenate([np.full(len(t[1][0]), g, np.int64)
                                 for g, t in enumerate(tables)])
    lines = tuple(np.concatenate([t[0][i] for t in tables])
                  for i in range(4))
    edges = tuple(np.concatenate([t[1][i] for t in tables])
                  for i in range(4))
    _draw_lines(mask, line_group, lines)
    _fill_edges(mask, edge_group, edges)
    return mask


def fill_poly(polys: Sequence[np.ndarray], height: int, width: int,
              device: Union[str, torch.device] = 'cpu') -> torch.Tensor:
    """``cv2.fillPoly(zeros((height, width), uint8), polys, 1)`` as a
    (height, width) uint8 tensor on ``device``."""
    return fill_polys([polys], height, width, device)[0]


# ---------------------------------------------------------------------------
# gt-frame masks (training)
# ---------------------------------------------------------------------------

def _frame_points(polygons, bbox, size: int) -> List[np.ndarray]:
    """tpudet's points of a gt's polygons in its box frame (float32
    arithmetic, rounded half to even to int32)."""
    x1, y1, x2, y2 = bbox
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    pts = []
    for poly in polygons:
        p = np.asarray(poly, np.float32).reshape(-1, 2)
        p = (p - [x1, y1]) / [w, h] * size
        pts.append(np.round(p).astype(np.int32))
    return pts


def gt_frame_masks(segmentations, bboxes, size: int = 56,
                   device: Union[str, torch.device] = 'cpu'
                   ) -> torch.Tensor:
    """The (G, size, size) float32 gt-frame masks of an image's gts, on
    ``device``: each gt's polygon list rasterized in its own box frame
    (``polygons_to_gt_frame_mask``), and a full-box mask where the
    segmentation is missing or an RLE, as tpudet's ``LoadAnnotations``."""
    groups = [_frame_points(seg, box, size)
              if seg and isinstance(seg, (list, tuple)) else None
              for seg, box in zip(segmentations, bboxes)]
    masks = fill_polys([g or [] for g in groups], size, size, device).float()
    full = torch.as_tensor([g is None for g in groups], dtype=torch.bool)
    masks[full.to(masks.device)] = 1.0
    return masks


def polygons_to_gt_frame_mask(polygons: Sequence[np.ndarray],
                              bbox: np.ndarray, size: int = 56,
                              device: Union[str, torch.device] = 'cpu'
                              ) -> torch.Tensor:
    """Rasterize COCO polygon(s) into the gt bbox frame at size x size: a
    (size, size) float32 tensor on ``device``."""
    return fill_poly(_frame_points(polygons, bbox, size), size, size,
                     device).float()


def mask_targets_from_gt_frame(gt_frame_masks: torch.Tensor,
                               gt_boxes: torch.Tensor, rois: torch.Tensor,
                               out_size: int = 28) -> torch.Tensor:
    """Resample gt-frame masks into roi frames, on their device.

    Args:
        gt_frame_masks: (P, S, S) masks in their gt-box frames, gathered
            per roi; gt_boxes: (P, 4) xyxy, gathered alike; rois: (P, 4).

    Returns (P, out, out) targets in the rois' dtype, at least float32: two
    separable tent-weight resamples, as tpudet's."""
    dtype = torch.promote_types(rois.dtype, torch.float32)
    gt_frame_masks = gt_frame_masks.to(dtype)
    gt_boxes, rois = gt_boxes.to(dtype), rois.to(dtype)
    s = gt_frame_masks.shape[-1]
    gx1, gy1 = gt_boxes[:, 0], gt_boxes[:, 1]
    gw = torch.clamp_min(gt_boxes[:, 2] - gx1, 1e-3)
    gh = torch.clamp_min(gt_boxes[:, 3] - gy1, 1e-3)
    rx1, ry1 = rois[:, 0], rois[:, 1]
    rw = torch.clamp_min(rois[:, 2] - rx1, 1e-3)
    rh = torch.clamp_min(rois[:, 3] - ry1, 1e-3)
    dev = rois.device
    # output pixel o (centre (o + .5) / out of the roi) in gt-frame pixels
    o = (torch.arange(out_size, dtype=dtype, device=dev) + 0.5) / out_size
    sy = (ry1[:, None] + o[None] * rh[:, None] - gy1[:, None]) / \
        gh[:, None] * s - 0.5
    sx = (rx1[:, None] + o[None] * rw[:, None] - gx1[:, None]) / \
        gw[:, None] * s - 0.5
    c = torch.arange(s, dtype=dtype, device=dev)
    wy = torch.clamp_min(1. - (sy[..., None] - c).abs(), 0.)  # (P, out, S)
    wx = torch.clamp_min(1. - (sx[..., None] - c).abs(), 0.)
    tmp = torch.einsum('poy,pyx->pox', wy, gt_frame_masks)
    return torch.einsum('pqx,pox->poq', wx, tmp)


# ---------------------------------------------------------------------------
# inference: bitmaps, the paste and RLEs (reference fcn_mask_head.py
# get_seg_masks, mmdet/core/mask/utils.py encode_mask_results)
# ---------------------------------------------------------------------------

def segmentation_to_bitmap(segm, height: int, width: int) -> np.ndarray:
    """COCO segmentation (polygon list or RLE dict) -> (H, W) uint8;
    polygons of fewer than 3 points are skipped, as tpudet skips them."""
    if segm is None:
        return np.zeros((height, width), np.uint8)
    if isinstance(segm, dict):  # RLE
        return decode_rle(segm)
    pts = [np.round(np.asarray(p, np.float32).reshape(-1, 2)).astype(
        np.int32) for p in segm if len(p) >= 6]
    if not pts:
        return np.zeros((height, width), np.uint8)
    return fill_poly(pts, height, width).numpy()


def _linear_taps(pos: torch.Tensor, dst: torch.Tensor, src: int):
    """cv2's ``INTER_LINEAR`` taps of output positions ``pos`` for an
    output of ``dst`` pixels (broadcast) from ``src``: ``fx = (pos + .5) *
    src / dst - .5`` in double, the source pixel ``floor(fx)`` and its
    neighbour, the weight ``fx - floor(fx)`` as float32; at the borders
    the edge pixel with weight 0."""
    scale = src / dst.double()
    fx = (pos.double() + 0.5) * scale - 0.5
    s0 = torch.floor(fx)
    frac = (fx - s0).float()
    s0 = s0.long()
    border = (s0 < 0) | (s0 >= src - 1)
    frac = torch.where(border, torch.zeros_like(frac), frac)
    s0 = s0.clamp(0, src - 1)
    s1 = torch.clamp_max(s0 + 1, src - 1)
    return s0, s1, frac


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """cv2's float ``a + (b - a) * f`` with one rounding of the
    multiply-add (a fused multiply-add in cv2): ``b - a`` in float32, the
    product and the sum in double (exact product), rounded to float32."""
    return ((b - a).double() * f.double() + a.double()).float()


def _windows(boxes: torch.Tensor, height: int, width: int):
    """tpudet's integer paste windows: floor / ceil of each box, clipped
    to the image; (x1, y1, w, h) as int64, w or h <= 0 for none."""
    boxes = boxes.float()
    x1 = torch.floor(boxes[:, 0]).long().clamp_min(0)
    y1 = torch.floor(boxes[:, 1]).long().clamp_min(0)
    x2 = torch.ceil(boxes[:, 2]).long().clamp_max(width)
    y2 = torch.ceil(boxes[:, 3]).long().clamp_max(height)
    return x1, y1, x2 - x1, y2 - y1


PASTE_CHUNK_PIXELS = 1 << 26


def paste_masks(probs: torch.Tensor, boxes: torch.Tensor, height: int,
                width: int, thr: float = 0.5) -> torch.Tensor:
    """Paste a batch of per-detection mask probabilities into the image,
    on their device.

    Args:
        probs: (D, s, s) float mask probabilities in each box frame.
        boxes: (D, 4) xyxy in image coordinates.

    Returns (D, height, width) bool masks held column-major (a transposed
    view of a (D, width, height) tensor): each detection's probabilities
    resized to its integer window (tpudet's floor / ceil, clipped to the
    image) by cv2's ``INTER_LINEAR`` arithmetic and thresholded ``> thr``,
    False outside the window. Detections go through in chunks of at most
    PASTE_CHUNK_PIXELS output pixels."""
    d, s = probs.shape[0], probs.shape[-1]
    dev = probs.device
    out = torch.zeros((d, width, height), dtype=torch.bool, device=dev)
    if d == 0 or height <= 0 or width <= 0:
        return out.transpose(1, 2)
    x1, y1, w, h = _windows(boxes, height, width)
    cols = torch.arange(width, device=dev)
    rows = torch.arange(height, device=dev)
    step = max(1, PASTE_CHUNK_PIXELS // (height * width))
    for lo in range(0, d, step):
        sl = slice(lo, lo + step)
        p = probs[sl].float()
        n = p.shape[0]
        # columns of the image in each window, and their source taps
        dxs = cols[None] - x1[sl, None]
        in_x = (dxs >= 0) & (dxs < w[sl, None])
        sx0, sx1, fx = _linear_taps(dxs.clamp_min(0), w[sl, None].clamp_min(1),
                                    s)
        # horizontal pass over the s source rows: (n, W, s)
        a = torch.gather(p, 2, sx0[:, None].expand(n, s, width))
        b = torch.gather(p, 2, sx1[:, None].expand(n, s, width))
        tmp = _lerp(a, b, fx[:, None]).transpose(1, 2).contiguous()
        # vertical pass: (n, W, H), column-major
        dys = rows[None] - y1[sl, None]
        in_y = (dys >= 0) & (dys < h[sl, None])
        sy0, sy1, fy = _linear_taps(dys.clamp_min(0), h[sl, None].clamp_min(1),
                                    s)
        a = torch.gather(tmp, 2, sy0[:, None].expand(n, width, height))
        b = torch.gather(tmp, 2, sy1[:, None].expand(n, width, height))
        val = _lerp(a, b, fy[:, None])
        out[sl] = (val > thr) & in_x[:, :, None] & in_y[:, None, :]
    return out.transpose(1, 2)


def paste_mask_probs(probs: np.ndarray, boxes: np.ndarray, height: int,
                     width: int, thr: float = 0.5) -> np.ndarray:
    """tpudet's ``paste_mask_probs`` in numpy, one detection at a time:
    (D, H, W) uint8 binary masks, each detection's probabilities resized
    to its window by cv2's ``INTER_LINEAR`` arithmetic (``paste_masks``
    computes the same pixels for a batch on a device)."""
    probs = np.asarray(probs, np.float32)
    boxes = np.asarray(boxes, np.float32)
    d, s = probs.shape[0], probs.shape[-1]
    out = np.zeros((d, height, width), np.uint8)

    def taps(dst):
        fx = (np.arange(dst) + 0.5) * (s / dst) - 0.5
        s0 = np.floor(fx)
        frac = (fx - s0).astype(np.float32)
        s0 = s0.astype(np.int64)
        border = (s0 < 0) | (s0 >= s - 1)
        frac[border] = 0
        s0 = np.clip(s0, 0, s - 1)
        return s0, np.minimum(s0 + 1, s - 1), frac

    def lerp(a, b, f):
        return ((b - a).astype(np.float64) * f + a).astype(np.float32)

    for i in range(d):
        x1 = max(int(np.floor(boxes[i, 0])), 0)
        y1 = max(int(np.floor(boxes[i, 1])), 0)
        x2 = min(int(np.ceil(boxes[i, 2])), width)
        y2 = min(int(np.ceil(boxes[i, 3])), height)
        w, h = x2 - x1, y2 - y1
        if w <= 0 or h <= 0:
            continue
        sx0, sx1, fx = taps(w)
        sy0, sy1, fy = taps(h)
        tmp = lerp(probs[i][:, sx0], probs[i][:, sx1], fx)
        m = lerp(tmp[sy0], tmp[sy1], fy[:, None])
        out[i, y1:y2, x1:x2] = (m > thr).astype(np.uint8)
    return out


def encode_rle(mask: np.ndarray) -> dict:
    """(H, W) binary -> COCO-style uncompressed RLE (column-major runs,
    counts starting with the 0-run)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).flatten(order='F').astype(np.uint8)
    if flat.size == 0:
        return dict(size=[h, w], counts=[0])
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(idx).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return dict(size=[h, w], counts=runs)


def encode_rle_batch(masks: torch.Tensor) -> List[dict]:
    """``encode_rle`` of each of (D, H, W) binary masks, on their device:
    the positions where the column-major sequence changes (and each first
    pixel) are found there; the host turns them into the run lengths. The
    column-major order is free when ``masks`` is ``paste_masks``'s
    output."""
    d, h, w = masks.shape
    if h * w == 0:
        return [dict(size=[h, w], counts=[0]) for _ in range(d)]
    flat = masks.transpose(1, 2).reshape(d, h * w).bool()
    change = torch.nonzero(flat[:, 1:] != flat[:, :-1]).cpu().numpy()
    first = flat[:, 0].cpu().numpy()
    bounds = np.split(change[:, 1] + 1,
                      np.searchsorted(change[:, 0], np.arange(1, d)))
    out = []
    for i in range(d):
        idx = np.concatenate([[0], bounds[i], [h * w]])
        runs = np.diff(idx).tolist()
        if first[i]:
            runs = [0] + runs
        out.append(dict(size=[h, w], counts=runs))
    return out


def decode_rle(rle: dict) -> np.ndarray:
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, (bytes, str)):
        raise ValueError('compressed RLE strings are not produced by '
                         'tpudet; decode with pycocotools')
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((h, w), order='F')


def rle_area(rle: dict) -> int:
    return int(sum(rle['counts'][1::2]))


def _ones_runs(m):
    """The 1-runs of a mask (binary array or uncompressed RLE) as (start,
    end) column-major positions, sorted and disjoint."""
    if isinstance(m, dict):
        counts = m['counts']
        if isinstance(counts, (bytes, str)):
            raise ValueError('compressed RLE strings are not produced by '
                             'tpudet; decode with pycocotools')
        counts = np.asarray(counts, np.int64)
    else:
        counts = np.asarray(encode_rle(np.asarray(m))['counts'], np.int64)
    edges = np.cumsum(counts)
    n = len(counts) // 2
    return edges[0:2 * n:2], edges[1:2 * n + 1:2]


def _covered(starts, ends, cum, p):
    """How many positions below each ``p`` the runs cover."""
    if not len(starts):
        return np.zeros(len(p), np.int64)
    k = np.searchsorted(ends, p, side='right')
    part = np.where(k < len(starts),
                    np.clip(p - starts[np.minimum(k, len(starts) - 1)], 0,
                            None), 0)
    return cum[k] + part


def mask_iou_matrix(det_masks, gt_masks, gt_crowd=None) -> np.ndarray:
    """IoU between detection and gt masks with COCO crowd semantics
    (crowd gt: union = det area only, as ``iou_coco``), computed from the
    masks' runs.

    Args: lists of (H, W) binary arrays or uncompressed RLE dicts."""
    dets = [_ones_runs(m) for m in det_masks]
    gts = [_ones_runs(m) for m in gt_masks]
    if gt_crowd is None:
        gt_crowd = np.zeros(len(gts), bool)
    ious = np.zeros((len(dets), len(gts)), np.float32)
    if not dets or not gts:
        return ious
    det_owner = np.concatenate([np.full(len(s), i) for i, (s, _) in
                                enumerate(dets)]).astype(np.int64)
    det_s = np.concatenate([s for s, _ in dets])
    det_e = np.concatenate([e for _, e in dets])
    det_area = np.array([int((e - s).sum()) for s, e in dets], np.int64)
    for j, (gs, ge) in enumerate(gts):
        cum = np.concatenate([[0], np.cumsum(ge - gs)])
        per_run = (_covered(gs, ge, cum, det_e) -
                   _covered(gs, ge, cum, det_s))
        inter = np.bincount(det_owner, per_run, minlength=len(dets)) \
            .astype(np.int64)
        g_area = int(cum[-1])
        union = det_area if gt_crowd[j] else det_area + g_area - inter
        with np.errstate(divide='ignore', invalid='ignore'):
            ious[:, j] = np.where(union > 0, inter / union, 0.0)
    return ious
