"""Detection and instance-mask drawing without cv2: counterpart of
``tpudet/visualization.py`` (``imshow_det_bboxes``,
``imshow_gt_det_bboxes``, ``_palette``).

The drawing runs in numpy on the host, on a BGR uint8 (H, W, 3) array. A
picture holds a few dozen boxes and labels, each a handful of slice
writes: launches on a card would cost more than the drawing, and the
picture goes to a file or a screen on the host anyway. A file path is
read as ``LoadImageFromFile`` reads it on ``device``: cv2 on the CPU, a
JPEG decoded with nvJPEG on a CUDA device.

- Boxes equal ``cv2.rectangle(img, p1, p2, color, thickness)`` bit for
  bit, clipped to the image: for thickness 1 the outline; thicker, cv2's
  thick lines, bands ``(t + t % 2) // 2`` px to each side of each edge and
  discs of radius ``(t + 1) // 2`` at the corners.
- Mask overlays equal ``cv2.addWeighted(overlay, a, img, 1 - a, 0, img)``
  on uint8 bit for bit: ``fma(overlay, a, float32(img * b))`` in float32,
  rounded half to even and saturated.
- Labels are drawn with the 5 x 7 bitmap font below (printable ASCII),
  ``max(1, int(2 * font_scale))`` pixels a font pixel, anchored
  bottom-left at ``(x1, max(y1 - 4, 0))`` as tpudet anchors its
  ``cv2.putText``. tpudet's Hershey glyphs are not reproduced; for
  ``font_scale >= 0.5`` the text stays inside the box
  ``cv2.getTextSize`` gives tpudet's label.
- ``out_file`` ending in ``.png`` is written by ``write_png`` (zlib, 8-bit
  RGB); any other suffix through ``cv2.imwrite``, which needs cv2.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

# 5 x 7 glyphs of printable ASCII (' ' to '~'), one string each: the
# glyph's columns left to right as hex bytes, bit 0 the top row and bit 6
# the baseline row. Narrow glyphs are narrow, so that a label is no wider
# than cv2's Hershey text of the same string.
_FONT = (
    '0000', '5f', '070007', '147f147f14', '242a7f2a12', '2313086462',
    '3649552250', '0503', '1c2241', '41221c', '082a1c2a08', '08083e0808',
    '5030', '0808080808', '6060', '2010080402', '3e5149453e', '427f40',
    '4261514946', '2141454b31', '1814127f10', '2745454539', '3c4a494930',
    '0171090503', '3649494936', '064949291e', '3636', '5636', '08142241',
    '1414141414', '41221408', '0201510906', '324979413e', '7e1111117e',
    '7f49494936', '3e41414122', '7f4141221c', '7f49494941', '7f09090101',
    '3e41415132', '7f0808087f', '7f', '2040413f01', '7f08142241',
    '7f40404040', '7f0204027f', '7f0408107f', '3e4141413e', '7f09090906',
    '3e4151215e', '7f09192946', '4649494931', '01017f0101', '3f4040403f',
    '1f2040201f', '7f2018207f', '6314081463', '0304780403', '6151494543',
    '7f4141', '0204081020', '41417f', '0402010204', '4040404040', '010204',
    '2054545478', '7f48444438', '3844444420', '384444487f', '3854545418',
    '087e0902', '0814545438', '7f08040478', '7d', '403d', '7f102844',
    '7f', '7c04180478', '7c08040478', '3844444438', '7c14141408',
    '081414187c', '7c080404', '4854545420', '043f4440', '3c4040207c',
    '1c2040201c', '3c4030403c', '4428102844', '0c5050503c', '4464544c44',
    '083641', '7f', '413608', '1008081008')
_GLYPHS = {chr(32 + i): np.array(
    [[(b >> r) & 1 for b in bytes.fromhex(g)] for r in range(7)], bool)
    for i, g in enumerate(_FONT)}


def _palette(n: int, seed: int = 42) -> Dict[int, tuple]:
    """A BGR colour per class, tpudet's draw from ``RandomState(42)``."""
    rng = np.random.RandomState(seed)
    return {c: tuple(int(x) for x in rng.randint(0, 255, 3))
            for c in range(max(n, 1))}


def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int,
          color) -> None:
    """Paint rows y0..y1 and columns x0..x1 (inclusive), clipped."""
    h, w = img.shape[:2]
    y0, x0 = max(y0, 0), max(x0, 0)
    y1, x1 = min(y1, h - 1), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def draw_rectangle(img: np.ndarray, pt1, pt2, color,
                   thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` with integer
    corners, in place: the outline for thickness 1; for thicker lines
    cv2's bands along the edges and discs at the corners."""
    if thickness < 1:
        raise ValueError(f'thickness {thickness}: filled rectangles are '
                         f'not drawn')
    (xa, ya), (xb, yb) = pt1, pt2
    x0, x1 = sorted((int(xa), int(xb)))
    y0, y1 = sorted((int(ya), int(yb)))
    hw = 0 if thickness == 1 else (thickness + (thickness & 1)) // 2
    for y in (y0, y1):
        _fill(img, y - hw, y + hw, x0, x1, color)
    for x in (x0, x1):
        _fill(img, y0, y1, x - hw, x + hw, color)
    r = (thickness + 1) // 2 if thickness > 1 else 0
    for cy in (y0, y1):
        for cx in (x0, x1):
            for dy in range(-r, r + 1):
                dx = int(np.sqrt(r * r - dy * dy))
                _fill(img, cy + dy, cy + dy, cx - dx, cx + dx, color)
    return img


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray,
                 beta: float, gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted`` on uint8 arrays: float32 ``fma(src1, alpha,
    fma(src2, beta, gamma))``, rounded half to even, saturated. In float64
    each product and the sum are exact before the one rounding to
    float32."""
    a, b, g = np.float32(alpha), np.float32(beta), np.float32(gamma)
    inner = (src2.astype(np.float64) * np.float64(b) +
             np.float64(g)).astype(np.float32)
    t = (src1.astype(np.float64) * np.float64(a) +
         inner.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


def draw_text(img: np.ndarray, text: str, org, color,
              font_scale: float = 0.5) -> np.ndarray:
    """``text`` in the module's bitmap font, in place, its baseline row
    at ``org[1] - 1`` and its first column at ``org[0]``; characters
    outside printable ASCII draw as '?'."""
    k = max(1, int(2 * font_scale))
    x, y = int(org[0]), int(org[1]) - 7 * k
    h, w = img.shape[:2]
    for ch in text:
        glyph = _GLYPHS.get(ch, _GLYPHS['?'])
        cell = np.kron(glyph, np.ones((k, k), bool))
        ys, xs = np.nonzero(cell)
        ys, xs = ys + y, xs + x
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = color
        x += (glyph.shape[1] + 1) * k
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) BGR uint8 image as an 8-bit RGB PNG: rows unfiltered,
    one zlib stream."""
    img = np.asarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'write_png takes (H, W, 3) images, not '
                         f'{img.shape}')
    img = np.ascontiguousarray(img[..., ::-1])
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack('>I', len(data)) + kind + data +
                struct.pack('>I', zlib.crc32(kind + data)))

    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' +
                chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(raw, 6)) +
                chunk(b'IEND', b''))


def read_png(path: str) -> np.ndarray:
    """The (H, W, 3) BGR uint8 image of a PNG that ``write_png`` wrote
    (8-bit RGB, unfiltered rows); other PNGs raise ``ValueError``."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f'{path} is not a PNG')
    pos, idat, header = 8, b'', None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat += body
        pos += 12 + n
    w, h, depth, color_type, _, _, interlace = header
    if (depth, color_type, interlace) != (8, 2, 0):
        raise ValueError(f'{path}: not an 8-bit RGB PNG')
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f'{path}: filtered rows')
    return np.ascontiguousarray(rows[:, 1:].reshape(h, w, 3)[..., ::-1])


def has_cv2() -> bool:
    """Whether cv2 imports here (the card's machine has none)."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def write_image(out_file: str, img: np.ndarray) -> None:
    """``.png`` through ``write_png``; any other suffix through
    ``cv2.imwrite``, which raises ``ImportError`` without cv2."""
    if out_file.lower().endswith('.png'):
        write_png(out_file, img)
        return
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f'writing {out_file!r} needs cv2, which is not installed; name '
            f'a .png file, which the port writes without it') from e
    if not cv2.imwrite(out_file, img):
        raise OSError(f'cv2.imwrite could not write {out_file!r}')


def _load(img: Union[str, np.ndarray],
          device: Union[str, torch.device]) -> np.ndarray:
    """A file path decoded as ``LoadImageFromFile`` on ``device`` decodes
    it, or an array, as a contiguous BGR uint8 host array."""
    if isinstance(img, str):
        from .data.pipelines import LoadImageFromFile
        img = LoadImageFromFile(device=device)(
            dict(img_info=dict(filename=img), img_prefix=None))['img']
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    return np.ascontiguousarray(img)


def _as_bitmap(segm, h: int, w: int) -> np.ndarray:
    from .core.mask import segmentation_to_bitmap
    if isinstance(segm, np.ndarray) and segm.ndim == 2:
        return segm.astype(np.uint8)
    return segmentation_to_bitmap(segm, h, w)


def _overlay(img: np.ndarray, mask: np.ndarray, color, alpha: float,
             beta: float) -> None:
    """tpudet's mask overlay, in place: the image with the mask painted,
    blended over the image."""
    overlay = img.copy()
    overlay[mask] = color
    img[...] = add_weighted(overlay, alpha, img, beta, 0)


def imshow_det_bboxes(img: Union[str, np.ndarray],
                      result,
                      class_names: Sequence[str],
                      score_thr: float = 0.3,
                      thickness: int = 2,
                      font_scale: float = 0.5,
                      mask_alpha: float = 0.45,
                      out_file: Optional[str] = None,
                      device: Union[str, torch.device] = 'cuda'
                      ) -> np.ndarray:
    """Draw per-class detection arrays (and instance masks) onto the BGR
    image, in tpudet's order: for each class and each detection at or
    over ``score_thr``, its mask overlay, its box, its label.

    ``result`` is the bbox-only per-class list or the reference's
    two-tuple ``(bbox_results, segm_results)`` with per-class RLE/bitmap
    lists. A path ``img`` is decoded on ``device``, the card unless the
    caller asks for the CPU. Returns the drawn array; ``out_file`` also
    writes it.
    """
    img = _load(img, device)
    h, w = img.shape[:2]
    segm_result = None
    if isinstance(result, tuple) and len(result) == 2:
        result, segm_result = result
    colors = _palette(len(class_names))

    for cls, dets in enumerate(result):
        for j, det in enumerate(dets):
            if det[4] < score_thr:
                continue
            color = colors[cls]
            if segm_result is not None and j < len(segm_result[cls]):
                mask = _as_bitmap(segm_result[cls][j], h, w).astype(bool)
                _overlay(img, mask, color, mask_alpha, 1 - mask_alpha)
            x1, y1, x2, y2 = (int(v) for v in det[:4])
            draw_rectangle(img, (x1, y1), (x2, y2), color, thickness)
            draw_text(img, f'{class_names[cls]}: {det[4]:.2f}',
                      (x1, max(y1 - 4, 0)), color, font_scale)
    if out_file is not None:
        write_image(out_file, img)
    return img


def imshow_gt_det_bboxes(img: Union[str, np.ndarray],
                         annotation: Dict,
                         result,
                         class_names: Sequence[str],
                         score_thr: float = 0.3,
                         out_file: Optional[str] = None,
                         device: Union[str, torch.device] = 'cuda'
                         ) -> np.ndarray:
    """Ground truth (left) beside the detections (right), as tpudet's.

    ``annotation`` carries ``gt_bboxes`` (xyxy), ``gt_labels`` and
    optionally ``gt_masks`` (COCO segmentations). A path ``img`` is
    decoded on ``device``, as in ``imshow_det_bboxes``.
    """
    img = _load(img, device)
    h, w = img.shape[:2]
    colors = _palette(len(class_names))

    gt_img = img.copy()
    gt_bboxes = np.asarray(annotation['gt_bboxes'])
    gt_labels = np.asarray(annotation['gt_labels'])
    gt_masks = annotation.get('gt_masks')
    for i in range(len(gt_bboxes)):
        cls = int(gt_labels[i])
        color = colors.get(cls, (0, 255, 0))
        if gt_masks is not None and i < len(gt_masks) and \
                gt_masks[i] is not None:
            mask = _as_bitmap(gt_masks[i], h, w).astype(bool)
            _overlay(gt_img, mask, color, 0.45, 0.55)
        x1, y1, x2, y2 = (int(v) for v in gt_bboxes[i])
        draw_rectangle(gt_img, (x1, y1), (x2, y2), color, 2)
        name = class_names[cls] if cls < len(class_names) else str(cls)
        draw_text(gt_img, f'gt: {name}', (x1, max(y1 - 4, 0)), color, 0.5)

    det_img = imshow_det_bboxes(img.copy(), result, class_names,
                                score_thr=score_thr)
    canvas = np.concatenate([gt_img, det_img], axis=1)
    if out_file is not None:
        write_image(out_file, canvas)
    return canvas
