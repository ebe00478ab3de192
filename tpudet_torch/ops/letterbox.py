"""Letterbox a batch of decoded images: resize each into the top-left
corner of a fixed canvas, keeping its aspect ratio, and pad the rest.

The counterpart of the letterbox in tpudet's native JPEG loader
(``tpudet/ops/native/jpeg_loader.cc``: ``make_axis``,
``resize_bilinear_u8`` and the letterbox of ``decode_one``), which tpudet's
server runs on the host after each decode. On the card :func:`letterbox`
launches the hand-written kernel of ``csrc/letterbox.cu`` once for up to 64
images (and counts each launch in ``letterbox.launches``); on a CPU tensor
it computes :func:`letterbox_reference`, the same arithmetic in int64 torch
ops. Both equal tpudet's loader bit for bit:

- target size ``f = min(out_h / h, out_w / w)`` in double, ``nw = int(w f +
  0.5)``, ``nh = int(h f + 0.5)``, each clamped to ``[1, out]``;
- bilinear with half-pixel centres and 15-bit weights (:func:`axis_taps`),
  horizontal then vertical in int64, rounded once: ``(v + 2^29) >> 30``;
- ``pad_val`` elsewhere; scale factors ``float32(nw) / w``, ``float32(nh)
  / h``.

The canvas is uint8 in the images' channel order (BGR as decoded), or with
``to_rgb`` reversed; with ``norm=(mean, std)`` it is float32 ``(v - mean) /
std``, a true division as numpy's, which tpudet's server applies to its
canvas (``tools/deployment/serve.py:96-98``). A ``None`` image (a failed
decode) leaves its canvas all ``pad_val`` and its scale factors 0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MAX_IMAGES = 64  # images in one launch (csrc/letterbox.cu kMaxImages)


def target_size(h: int, w: int, out_h: int, out_w: int) -> Tuple[int, int]:
    """``(nh, nw)`` of an (h, w) image in an (out_h, out_w) canvas, as
    ``decode_one`` computes them (``jpeg_loader.cc:133-138``)."""
    f = min(out_h / h, out_w / w)
    nw = int(w * f + 0.5)
    nh = int(h * f + 0.5)
    return max(1, min(nh, out_h)), max(1, min(nw, out_w))


def scale_factor(h: int, w: int, nh: int, nw: int) -> np.ndarray:
    """``[sw, sh, sw, sh]`` in float32, ``sw = float32(nw) / w``."""
    sw = np.float32(nw) / np.float32(w)
    sh = np.float32(nh) / np.float32(h)
    return np.array([sw, sh, sw, sh], np.float32)


def axis_taps(src: int, dst: int, device=None):
    """``make_axis`` (``jpeg_loader.cc:55-75``): for each destination index
    ``d`` the source indices ``i0``, ``i1`` and the 15-bit weight ``w1`` of
    ``i1``, from ``s = (d + 0.5) * src / dst - 0.5`` in float64 (each op
    rounded), clamped to ``[0, src - 1]``, truncated, ``i0 <= src - 2``."""
    s = (torch.arange(dst, dtype=torch.float64, device=device) + 0.5) * (
        src / dst) - 0.5
    s = s.clamp(0, src - 1)
    i0 = s.to(torch.int64).clamp_max(max(src - 2, 0))
    w1 = ((s - i0.double()) * 32768.0 + 0.5).to(torch.int64)
    return i0, (i0 + 1).clamp_max(src - 1), w1


def _resize(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """``resize_bilinear_u8`` of an (h, w, 3) uint8 tensor to (nh, nw)."""
    h, w = img.shape[:2]
    y0, y1, wy1 = axis_taps(h, nh, img.device)
    x0, x1, wx1 = axis_taps(w, nw, img.device)
    src = img.to(torch.int64)
    wx1 = wx1[None, :, None]
    wx0 = 32768 - wx1
    r0, r1 = src[y0], src[y1]
    top = r0[:, x0] * wx0 + r0[:, x1] * wx1
    bot = r1[:, x0] * wx0 + r1[:, x1] * wx1
    wy1 = wy1[:, None, None]
    v = top * (32768 - wy1) + bot * wy1  # scale 2^30
    return ((v + (1 << 29)) >> 30).to(torch.uint8)


def _norm_table(norm: Tuple[float, float]) -> torch.Tensor:
    """``(v - mean) / std`` of every uint8 ``v`` in float32, by numpy."""
    mean, std = np.float32(norm[0]), np.float32(norm[1])
    return torch.from_numpy((np.arange(256, dtype=np.float32) - mean) / std)


def _sizes(images, out_h, out_w) -> List[Tuple[int, int, int, int]]:
    """``(h, w, nh, nw)`` of each image; zeros for a ``None``."""
    sizes = []
    for img in images:
        if img is None:
            sizes.append((0, 0, 0, 0))
            continue
        if img.dim() != 3 or img.shape[2] != 3 or img.dtype != torch.uint8:
            raise ValueError(f'letterbox: want (h, w, 3) uint8 images, got '
                             f'{tuple(img.shape)} {img.dtype}')
        h, w = int(img.shape[0]), int(img.shape[1])
        if h <= 0 or w <= 0:
            raise ValueError(f'letterbox: empty image {(h, w)}')
        sizes.append((h, w) + target_size(h, w, out_h, out_w))
    return sizes


def _scale_factors(sizes) -> np.ndarray:
    sf = np.zeros((len(sizes), 4), np.float32)
    for i, (h, w, nh, nw) in enumerate(sizes):
        if h:
            sf[i] = scale_factor(h, w, nh, nw)
    return sf


def _canvas(n, out_h, out_w, norm, out, device):
    dtype = torch.uint8 if norm is None else torch.float32
    if out is None:
        return torch.empty((n, out_h, out_w, 3), dtype=dtype, device=device)
    if (out.dim() != 4 or out.shape[0] < n or tuple(out.shape[1:]) != (
            out_h, out_w, 3) or out.dtype != dtype or out.device != device
            or not out.is_contiguous()):
        raise ValueError(f'letterbox: out {tuple(out.shape)} {out.dtype} '
                         f'{out.device} cannot take {n} canvases of '
                         f'{(out_h, out_w, 3)} {dtype} on {device}')
    return out[:n]


def letterbox_reference(images: Sequence[Optional[torch.Tensor]], out_h: int,
                        out_w: int, pad_val: int = 0, *, to_rgb: bool = False,
                        norm: Optional[Tuple[float, float]] = None,
                        out: Optional[torch.Tensor] = None,
                        device=None) -> Tuple[torch.Tensor, np.ndarray]:
    """Plain PyTorch letterbox, the kernel's function: the canvases (n,
    out_h, out_w, 3) on the images' device (or ``device``) and the scale
    factors (n, 4), float32 on the host. Arguments as :func:`letterbox`."""
    device = _device(images, device)
    sizes = _sizes(images, out_h, out_w)
    canvas = torch.full((len(images), out_h, out_w, 3), pad_val,
                        dtype=torch.uint8, device=device)
    for i, (img, (h, w, nh, nw)) in enumerate(zip(images, sizes)):
        if h:
            canvas[i, :nh, :nw] = _resize(img, nh, nw)
    if to_rgb:
        canvas = canvas.flip(-1)
    if norm is not None:
        canvas = _norm_table(norm).to(device)[canvas.long()]
    res = _canvas(len(images), out_h, out_w, norm, out, device)
    res.copy_(canvas)
    return res, _scale_factors(sizes)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, built and loaded on first use."""
    from .build import load
    fn = load('letterbox').tpudet_letterbox
    i, f, ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = [ptr, i, ptr, i, i, i, i, i, f, f, ptr]
    fn.restype = ctypes.c_int
    return fn


def _indexed(device) -> torch.device:
    """``device`` with its index: a tensor on ``cuda`` lies on
    ``cuda:<current device>``, and ``torch.device('cuda')`` is not equal
    to ``torch.device('cuda:0')``."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _device(images, device) -> torch.device:
    devices = {img.device for img in images if img is not None}
    if device is not None:
        devices.add(_indexed(device))
    if len(devices) != 1:
        raise ValueError(f'letterbox: images on {sorted(map(str, devices))}'
                         '; want one device (pass device= for a batch of '
                         'None)')
    return devices.pop()


def letterbox(images: Sequence[Optional[torch.Tensor]], out_h: int,
              out_w: int, pad_val: int = 0, *, to_rgb: bool = False,
              norm: Optional[Tuple[float, float]] = None,
              out: Optional[torch.Tensor] = None,
              device=None) -> Tuple[torch.Tensor, np.ndarray]:
    """Letterbox (h, w, 3) uint8 images (``None`` for a failed decode) into
    canvases (n, out_h, out_w, 3): uint8, or float32 ``(v - mean) / std``
    with ``norm=(mean, std)``; channels reversed with ``to_rgb``. Writes
    into ``out[:n]`` when given. Returns the canvases and the scale
    factors ``[sw, sh, sw, sh]`` (n, 4), float32 on the host (0 for a
    ``None``).

    CUDA images launch the kernel of ``csrc/letterbox.cu``, one launch per
    64 images, each counted in ``letterbox.launches``; CPU images take
    :func:`letterbox_reference`. Images must be contiguous."""
    device = _device(images, device)
    if device.type == 'cpu':
        return letterbox_reference(images, out_h, out_w, pad_val,
                                   to_rgb=to_rgb, norm=norm, out=out,
                                   device=device)
    if device.type != 'cuda':
        raise ValueError(f'letterbox: unsupported device {device}')
    if not 0 <= pad_val <= 255:
        raise ValueError(f'letterbox: pad_val {pad_val} is not a uint8')
    sizes = _sizes(images, out_h, out_w)
    if any(img is not None and not img.is_contiguous() for img in images):
        raise ValueError('letterbox: images must be contiguous')
    canvas = _canvas(len(images), out_h, out_w, norm, out, device)
    mean, std = norm if norm is not None else (0.0, 1.0)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for start in range(0, len(images), MAX_IMAGES):
            chunk = range(start, min(start + MAX_IMAGES, len(images)))
            desc = np.zeros((len(chunk), 5), np.int64)
            for j, i in enumerate(chunk):
                if images[i] is not None:
                    desc[j] = (images[i].data_ptr(),) + sizes[i]
            err = _kernel()(desc.ctypes.data, len(chunk),
                            canvas[start].data_ptr(), out_h, out_w,
                            int(norm is not None), int(to_rgb), pad_val,
                            float(mean), float(std), stream)
            if err != 0:
                raise RuntimeError(f'letterbox kernel launch failed: '
                                   f'cudaError {err}')
            letterbox.launches += 1
    return canvas, _scale_factors(sizes)


letterbox.launches = 0
