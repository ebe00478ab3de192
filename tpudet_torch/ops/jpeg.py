"""JPEG decoding on the device: counterpart of ``tpudet/ops/native/
jpeg_native.py`` (``jpeg_info``, ``decode``, ``decode_letterbox``,
``decode_letterbox_batch``).

- :func:`jpeg_info` reads (h, w) from the header, the port's own marker
  walk, the same on every device.
- :func:`decode` on ``cuda`` runs nvJPEG (the CUDA toolkit's decoder,
  through the C shim ``csrc/nvjpeg_shim.cu``): the image decodes straight
  into an (h, w, 3) uint8 tensor on the device, on torch's current stream,
  with no host copy of the pixels. On ``cpu`` it runs the plain version,
  ``cv2.imdecode(..., IMREAD_COLOR)``, which tpudet's libjpeg decode equals
  bit for bit. nvJPEG's pixels differ from libjpeg's by a few levels (its
  IDCT and chroma upsampling are its own; PERF.md has the measured levels).
- :func:`decode_letterbox` and :func:`decode_letterbox_batch` decode, then
  letterbox with ``ops/letterbox.py`` (one kernel launch for the batch).

- :func:`decode_image` turns the bytes of any image into a tensor on the
  device: a JPEG with :func:`decode`, another format with cv2 on the host.

What tpudet's libjpeg path refuses is refused on both devices: bytes whose
header does not reach a scan, an empty image, and colour spaces other than
grayscale and YCbCr/RGB (CMYK, YCCK); a decode that fails on the bytes
returns ``None``. A failure of the device (nvJPEG's execution, allocator
or internal errors, a CUDA error) raises ``RuntimeError`` instead. Neither
device falls back to the other: with no ``libnvjpeg``, a ``cuda`` decode
raises. EXIF orientation is ignored on the card, as tpudet's libjpeg path
ignores it; ``cv2.imdecode`` applies it.

Threads: one nvJPEG handle a process, one decoder state a thread that
decodes (the server's dispatcher, a loader's prefetch thread). A state's
decode first waits for its previous decode's copies to leave the state's
pinned buffers (``csrc/nvjpeg_shim.cu``): the host stage of the next
image would otherwise overwrite them while the stream runs behind.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device, to_device
from .letterbox import letterbox

# start-of-frame markers (every SOFn but DHT C4, JPG C8 and DAC CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# markers without a length: TEM, RSTn, SOI
_STANDALONE = frozenset([0x01, 0xD8, *range(0xD0, 0xD8)])

FAST_SCALE_ITEM = ("fast_scale (libjpeg's DCT-domain downscale) is not "
                   "ported: ROADMAP.md, queue 1, 'fast_scale'")
NO_DECODER = 'no decoder for this image format on this machine'

# nvjpegStatus_t values that describe the bytes, not the device:
# INVALID_PARAMETER (a header nvJPEG cannot take), BAD_JPEG,
# JPEG_NOT_SUPPORTED, INCOMPLETE_BITSTREAM
BITSTREAM_STATUSES = frozenset([2, 3, 4, 10])


def _header(data: bytes) -> Optional[Tuple[int, int, int]]:
    """``(h, w, components)`` of the frame, or None where libjpeg's
    ``jpeg_read_header`` fails: no SOI first, the data ends (or EOI comes)
    before a complete SOS segment, SOS before SOF, or an empty frame."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    pos, frame = 2, None
    while True:
        while pos < n and data[pos] != 0xFF:  # stray bytes: libjpeg skips
            pos += 1
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            return None
        marker = data[pos]
        pos += 1
        if marker in _STANDALONE:
            continue
        if marker == 0xD9 or pos + 2 > n:
            return None
        length = (data[pos] << 8) | data[pos + 1]
        if length < 2 or pos + length > n:
            return None
        if marker in _SOF:
            if length < 8:
                return None
            h = (data[pos + 3] << 8) | data[pos + 4]
            w = (data[pos + 5] << 8) | data[pos + 6]
            frame = (h, w, data[pos + 7])
        elif marker == 0xDA:
            if frame is None or frame[0] <= 0 or frame[1] <= 0 or \
                    frame[2] <= 0:
                return None
            return frame
        pos += length


def jpeg_info(data: bytes) -> Optional[Tuple[int, int]]:
    """(h, w) from the header only, or None for bytes that are not a JPEG
    libjpeg would read (tpudet's ``jpeg_native.jpeg_info``)."""
    frame = _header(data)
    return None if frame is None else frame[:2]


def is_jpeg(data: bytes) -> bool:
    """Whether ``data`` starts with a JPEG's SOI marker."""
    return data[:2] == b'\xff\xd8'


class NvJpeg:
    """The nvJPEG shim of one process: its handle, and a decoder state for
    each thread that decodes (destroyed with the thread's local data)."""

    def __init__(self):
        from .build import load
        lib = load('nvjpeg_shim')
        ptr, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        pint, pptr = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ptr)
        lib.tpudet_nvjpeg_version.argtypes = [pint, pint, pint]
        lib.tpudet_nvjpeg_create.argtypes = [pptr]
        lib.tpudet_nvjpeg_destroy.argtypes = [ptr]
        lib.tpudet_nvjpeg_state_create.argtypes = [ptr, pptr]
        lib.tpudet_nvjpeg_state_destroy.argtypes = [ptr]
        lib.tpudet_nvjpeg_info.argtypes = [ptr, ctypes.c_char_p, size, pint,
                                           pint, pint, pint]
        lib.tpudet_nvjpeg_decode.argtypes = [ptr, ptr, ctypes.c_char_p, size,
                                             i, ptr, size, ptr]
        for fn in ('version', 'create', 'destroy', 'state_create',
                   'state_destroy', 'info', 'decode'):
            getattr(lib, f'tpudet_nvjpeg_{fn}').restype = i
        self.lib = lib
        v = [ctypes.c_int() for _ in range(3)]
        self._check(lib.tpudet_nvjpeg_version(*map(ctypes.byref, v)),
                    'nvjpegGetProperty')
        self.version = '.'.join(str(x.value) for x in v)
        handle = ctypes.c_void_p()
        self._check(lib.tpudet_nvjpeg_create(ctypes.byref(handle)),
                    'nvjpegCreateEx')
        self.handle = handle.value
        self.backend = 'NVJPEG_BACKEND_DEFAULT (nvjpegDecode)'
        self._local = threading.local()

    @staticmethod
    def _check(status: int, what: str):
        if status != 0:
            raise RuntimeError(f'{what} failed: nvjpegStatus_t {status}')

    @classmethod
    def decoded(cls, status: int, what: str) -> bool:
        """Whether a call succeeded (0); False where nvJPEG refused the
        bytes (:data:`BITSTREAM_STATUSES`). Any other status is a failure
        of the device (execution, allocator, internal; 1000 + a
        ``cudaError_t`` from the shim) and raises ``RuntimeError``."""
        if status in BITSTREAM_STATUSES:
            return False
        cls._check(status, what)
        return True

    def _state(self) -> int:
        state = getattr(self._local, 'state', None)
        if state is None:
            state = self._local.state = _State(self)
        return state.ptr

    def info(self, data: bytes) -> Optional[Tuple[int, int, int, int]]:
        """(h, w, components, subsampling) as nvJPEG reads the header, or
        None where it refuses it."""
        c, css, h, w = (ctypes.c_int() for _ in range(4))
        status = self.lib.tpudet_nvjpeg_info(
            self.handle, data, len(data), *map(ctypes.byref, (c, css, h, w)))
        if not self.decoded(status, 'nvjpegGetImageInfo'):
            return None
        return h.value, w.value, c.value, css.value

    @property
    def last_status(self) -> int:
        """The status of this thread's last decode (0: success)."""
        return getattr(self._local, 'status', 0)

    def decode(self, data: bytes, h: int, w: int, bgr: bool,
               device: torch.device) -> Optional[torch.Tensor]:
        """The (h, w, 3) uint8 image on ``device``, or None where nvJPEG
        refuses the bytes (its status in ``last_status``); raises
        ``RuntimeError`` on a failure of the device."""
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            status = self.lib.tpudet_nvjpeg_decode(
                self.handle, self._state(), data, len(data), int(bgr),
                out.data_ptr(), 3 * w, stream)
        self._local.status = status
        return out if self.decoded(status, 'nvjpegDecode') else None


class _State:
    """One thread's ``nvjpegJpegState_t``."""

    def __init__(self, nv: NvJpeg):
        self.destroy = nv.lib.tpudet_nvjpeg_state_destroy
        ptr = ctypes.c_void_p()
        nv._check(nv.lib.tpudet_nvjpeg_state_create(nv.handle,
                                                    ctypes.byref(ptr)),
                  'nvjpegJpegStateCreate')
        self.ptr = ptr.value

    def __del__(self):
        self.destroy(self.ptr)


_nvjpeg: Optional[NvJpeg] = None
_nvjpeg_lock = threading.Lock()


def nvjpeg() -> NvJpeg:
    """The process's nvJPEG, built and created on first use. Raises where
    the shim does not build or ``libnvjpeg`` does not load."""
    global _nvjpeg
    with _nvjpeg_lock:
        if _nvjpeg is None:
            _nvjpeg = NvJpeg()
        return _nvjpeg


def decode(data: bytes, bgr: bool = True,
           device: Union[str, torch.device] = 'cuda'
           ) -> Optional[torch.Tensor]:
    """Full-size decode of a JPEG -> (h, w, 3) uint8 tensor on ``device``,
    BGR by default (as cv2), grayscale as 3 equal channels; None where the
    bytes are not a JPEG libjpeg would decode. ``cuda`` decodes with nvJPEG
    on the current stream; ``cpu`` with ``cv2.imdecode``."""
    device = resolve_device(device)
    frame = _header(data)
    if frame is None or frame[2] not in (1, 3):
        return None
    h, w, _ = frame
    if device.type == 'cuda':
        nv = nvjpeg()
        info = nv.info(data)
        if info is None or info[:2] != (h, w):
            return None
        return nv.decode(data, h, w, bgr, device)
    if device.type != 'cpu':
        raise ValueError(f'decode: unsupported device {device}')
    cv2 = _cv2()
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(img if bgr else
                                                 img[..., ::-1]))


def _cv2():
    try:
        import cv2
    except ImportError:
        raise ImportError(f'{NO_DECODER}: decoding it needs cv2, which is '
                          'not installed') from None
    return cv2


def decode_image(data: bytes, device: Union[str, torch.device] = 'cuda'
                 ) -> Optional[torch.Tensor]:
    """Image bytes -> (h, w, 3) BGR uint8 tensor on ``device``, or None
    where the bytes do not decode. A JPEG decodes with :func:`decode`
    (nvJPEG on ``cuda``); any other format with ``cv2.imdecode`` on the
    host, then goes to the device. Raises ``ImportError`` (starting with
    :data:`NO_DECODER`) where that needs cv2 and cv2 is not installed, and
    ``RuntimeError`` on a failure of the device."""
    device = resolve_device(device)
    if is_jpeg(data):
        return decode(data, bgr=True, device=device)
    cv2 = _cv2()
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else to_device(img, device)


def decode_letterbox(jpeg: bytes, out_h: int, out_w: int, pad_val: int = 0,
                     bgr: bool = True, fast_scale: bool = False,
                     device: Union[str, torch.device] = 'cuda'
                     ) -> Optional[Tuple[torch.Tensor, np.ndarray]]:
    """Decode and letterbox one image: ``(canvas (out_h, out_w, 3) uint8 on
    the device, scale_factor [sw, sh, sw, sh] float32 on the host)``, or
    None where the decode fails."""
    canvases, sf, status = decode_letterbox_batch(
        [jpeg], out_h, out_w, pad_val, bgr, fast_scale, device)
    return None if status[0] else (canvases[0], sf[0])


def decode_letterbox_batch(jpegs: Sequence[bytes], out_h: int, out_w: int,
                           pad_val: int = 0, bgr: bool = True,
                           fast_scale: bool = False,
                           device: Union[str, torch.device] = 'cuda'
                           ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Decode each image, then letterbox the batch in one launch:
    ``(canvases (n, out_h, out_w, 3) uint8 on the device, scale_factors (n,
    4) float32, status (n,) int32)``, the last two on the host.
    ``status[i] != 0`` marks a failed decode, whose canvas is all
    ``pad_val`` and scale factors 0."""
    if fast_scale:
        raise NotImplementedError(FAST_SCALE_ITEM)
    device = resolve_device(device)
    images: List[Optional[torch.Tensor]] = [
        decode(j, bgr=bgr, device=device) for j in jpegs]
    status = np.array([img is None for img in images], np.int32)
    canvases, sf = letterbox(images, out_h, out_w, pad_val, device=device)
    return canvases, sf, status
