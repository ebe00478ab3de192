"""The port's JPEG header parse, decode and letterbox (``tpudet_torch/ops/
jpeg.py``, ``ops/letterbox.py``) against tpudet's native libjpeg loader
(``tpudet/ops/native/jpeg_native.py``), on the CPU.

Inputs: the committed fixtures ``tests/torch_fixtures/jpeg`` (12 JPEGs in
every form the decoder must read, and a file cut inside its scan header)
and small JPEGs cv2 encodes here. tpudet's loader is built into a
temporary directory (``tests/torch_fixtures``), never next to its source.

Tolerances: header sizes, decodes, canvases and the float canvas equal bit
for bit; scale factors to rtol 1e-6.
"""
import contextlib
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from tests.torch_fixtures import (JPEG_DIR, jpeg_bytes, jpeg_manifest,
                                  tpudet_native_jpeg)
from tpudet_torch.ops import jpeg, letterbox as L
from tpudet_torch.tools import jpeg_fixtures

NAMES = sorted(jpeg_manifest())
DECODED = [n for n in NAMES if n != jpeg_fixtures.TRUNCATED]
SIZES = [(640, 640), (320, 416)]  # (out_h, out_w)
NORM = (114.0, 255.0)


@pytest.fixture(scope='module')
def native(tmp_path_factory):
    with tpudet_native_jpeg(tmp_path_factory.mktemp('jpeg_native')) as n:
        yield n


def _encode(h, w, seed, **params):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    flags = [x for kv in params.items() for x in kv]
    ok, buf = cv2.imencode('.jpg', img, flags)
    assert ok
    return buf.tobytes()


ODD = {'1x1': (1, 1), '7x3': (7, 3), '3x7': (3, 7), '333x1': (333, 1),
       '1x333': (1, 333), '17x1000': (17, 1000), '2x2': (2, 2)}


@pytest.mark.parametrize('name', NAMES)
def test_jpeg_info_matches_tpudet(native, name):
    data = jpeg_bytes(name)
    assert jpeg.jpeg_info(data) == native.jpeg_info(data)


@pytest.mark.parametrize('size', ODD)
def test_jpeg_info_odd_sizes(native, size):
    data = _encode(*ODD[size], seed=1)
    assert jpeg.jpeg_info(data) == native.jpeg_info(data) == ODD[size]


def test_jpeg_info_refuses_what_libjpeg_refuses(native):
    data = jpeg_bytes('rgb_96x128.jpg')
    sos = data.find(b'\xff\xda')
    sof = data.find(b'\xff\xc0')
    _, png = cv2.imencode('.png', np.zeros((4, 4, 3), np.uint8))
    cases = {
        'empty': b'', 'ff': b'\xff', 'soi': b'\xff\xd8',
        'noise': np.random.RandomState(0).bytes(300),
        'png': png.tobytes(),
        'soi_eoi': b'\xff\xd8\xff\xd9',
        'cut_after_sof': data[:sof + 19],
        'cut_in_sos': data[:sos + 6],
        'sos_before_sof': data[:sof] + data[sos:],
        'zero_height': data[:sof + 5] + b'\x00\x00' + data[sof + 7:],
    }
    for what, b in cases.items():
        assert jpeg.jpeg_info(b) is None, what
        assert native.jpeg_info(b) is None, what
    # bytes after the scan, and stray bytes before a marker, are read past
    assert jpeg.jpeg_info(data + b'junk') == native.jpeg_info(data + b'junk')
    stray = data[:sof] + b'\x00\x01' + data[sof:]
    assert jpeg.jpeg_info(stray) == native.jpeg_info(stray) == (96, 128)


@pytest.mark.parametrize('name', NAMES)
def test_decode_matches_tpudet(native, name):
    data = jpeg_bytes(name)
    for bgr in (True, False):
        got = jpeg.decode(data, bgr=bgr, device='cpu')
        ref = native.decode(data, bgr=bgr)
        assert (got is None) == (ref is None)
        if ref is not None:
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('pad', [0, 114])
@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('name', NAMES)
def test_letterbox_reference_matches_tpudet(native, name, size, pad):
    data = jpeg_bytes(name)
    got = jpeg.decode_letterbox(data, *size, pad_val=pad, device='cpu')
    ref = native.decode_letterbox(data, *size, pad_val=pad)
    assert (got is None) == (ref is None)
    if ref is None:
        return
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize('size', ODD)
def test_letterbox_edge_sizes_match_tpudet(native, size):
    """1-pixel sources (i0 = i1 = 0), upscales that clamp at both ends,
    and sources already at the canvas size (tpudet's memcpy branch)."""
    data = _encode(*ODD[size], seed=2)
    h, w = ODD[size]
    for out in ((64, 64), (h, w), (max(h, w) * 3, max(h, w) * 2)):
        got = jpeg.decode_letterbox(data, *out, pad_val=7, device='cpu')
        ref = native.decode_letterbox(data, *out, pad_val=7)
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize('name', DECODED)
def test_float_canvas_matches_tpudets_normalisation(native, name):
    """The server's canvas, ``(RGB - 114) / 255`` in float32, against
    tpudet's server normalising its native canvas
    (``tools/deployment/serve.py:96-98``)."""
    data = jpeg_bytes(name)
    canvas, sf = L.letterbox_reference([jpeg.decode(data, device='cpu')],
                                       640, 640, 114, to_rgb=True, norm=NORM)
    ref, ref_sf = native.decode_letterbox(data, 640, 640, pad_val=114)
    want = (ref[..., ::-1].astype(np.float32) - 114.0) / 255.0
    assert canvas.dtype == torch.float32
    np.testing.assert_array_equal(canvas[0].numpy(), want)
    np.testing.assert_allclose(sf[0], ref_sf, rtol=1e-6, atol=0)


def test_identity_size_equals_the_image():
    img = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (40, 56, 3)).astype(np.uint8))
    canvas, sf = L.letterbox_reference([img], 40, 56)
    assert torch.equal(canvas[0], img)
    np.testing.assert_array_equal(sf[0], [1, 1, 1, 1])
    i0, i1, w1 = L.axis_taps(56, 56)
    assert int(w1[-1]) == 32768 and int(w1[:-1].max()) == 0


def test_decode_letterbox_batch_marks_the_truncated_file(native):
    names = DECODED[:3] + [jpeg_fixtures.TRUNCATED]
    datas = [jpeg_bytes(n) for n in names]
    canvases, sf, status = jpeg.decode_letterbox_batch(
        datas, 320, 416, pad_val=114, device='cpu')
    ref_c, ref_sf, ref_status = native.decode_letterbox_batch(
        datas, 320, 416, pad_val=114)
    np.testing.assert_array_equal(status, [0, 0, 0, 1])
    assert (ref_status != 0).tolist() == [False, False, False, True]
    assert bool((canvases[3] == 114).all())
    np.testing.assert_array_equal(sf[3], np.zeros(4, np.float32))
    np.testing.assert_array_equal(canvases.numpy(), ref_c)
    np.testing.assert_allclose(sf, ref_sf, rtol=1e-6, atol=0)


def test_letterbox_of_a_failed_decode_is_all_pad():
    img = torch.zeros((5, 9, 3), dtype=torch.uint8)
    canvas, sf = L.letterbox_reference([None, img], 8, 8, 3)
    assert bool((canvas[0] == 3).all()) and sf[0].tolist() == [0] * 4
    canvas, sf = L.letterbox([None], 8, 8, 3, device='cpu')
    assert bool((canvas == 3).all())


def test_letterbox_writes_into_out_and_checks_it():
    img = torch.full((10, 20, 3), 200, dtype=torch.uint8)
    out = torch.full((3, 16, 16, 3), -1.0)
    canvas, _ = L.letterbox([img], 16, 16, 114, norm=NORM, out=out)
    assert canvas.data_ptr() == out.data_ptr()
    assert bool((out[1:] == -1).all())
    assert float(out[0, 0, 0, 0]) == np.float32(86.0) / np.float32(255.0)
    with pytest.raises(ValueError, match='cannot take'):
        L.letterbox([img], 16, 16, out=out)  # a float out for a uint8 canvas
    with pytest.raises(ValueError, match='uint8'):
        L.letterbox([img.float()], 16, 16)


def test_fast_scale_raises():
    data = jpeg_bytes('rgb_96x128.jpg')
    with pytest.raises(NotImplementedError, match='fast_scale'):
        jpeg.decode_letterbox(data, 64, 64, fast_scale=True, device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        jpeg.decode_letterbox_batch([data], 64, 64, fast_scale=True,
                                    device='cpu')


def test_decode_defaults_to_cuda_and_never_falls_back(monkeypatch):
    data = jpeg_bytes('rgb_96x128.jpg')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jpeg.decode(data)
    # with a card but no libnvjpeg, a cuda decode raises: no host decode
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)

    def no_library():
        raise OSError('libnvjpeg.so.12: cannot open shared object file')

    monkeypatch.setattr(jpeg, 'nvjpeg', no_library)
    with pytest.raises(OSError, match='libnvjpeg'):
        jpeg.decode(data, device='cuda')
    with pytest.raises(OSError, match='libnvjpeg'):
        jpeg.decode_letterbox_batch([data], 64, 64, device='cuda')


@pytest.mark.parametrize('name', DECODED)
def test_committed_decodes_equal_cv2(name):
    decoded = np.load(os.path.join(JPEG_DIR, 'decoded.npz'))
    ref = cv2.imdecode(np.frombuffer(jpeg_bytes(name), np.uint8),
                       cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decoded[name], ref)


def test_fixture_script_writes_the_committed_files(tmp_path):
    manifest = jpeg_fixtures.write(str(tmp_path))
    assert sorted(manifest) == NAMES
    for name in NAMES + ['manifest.json']:
        with open(tmp_path / name, 'rb') as f:
            assert f.read() == jpeg_bytes(name), name
    total = sum(os.path.getsize(os.path.join(JPEG_DIR, n))
                for n in os.listdir(JPEG_DIR))
    assert total < 4 * 2**20


def test_fixture_forms(native):
    """Each fixture is the JPEG form its name says."""
    m = jpeg_manifest()
    for name in DECODED:
        data = jpeg_bytes(name)
        form = m[name]['form']
        assert (b'\xff\xc2' in data) == (form == 'progressive'), name
        assert (b'\xff\xdd' in data) == (form == 'restart'), name
        sof = data.find(b'\xff\xc0' if form != 'progressive' else
                        b'\xff\xc2')
        comps = data[sof + 9]
        assert comps == (1 if form == 'gray' else 3), name
        if comps == 3:
            luma = data[sof + 11]  # sampling factors of Y
            assert luma == (0x11 if form == '444' else 0x22), name
        assert native.jpeg_info(data) == (m[name]['height'],
                                          m[name]['width'])


def test_port_modules_import_neither_cv2_nor_triton():
    """``ops/jpeg.py``, ``ops/letterbox.py`` and the server import cv2 only
    when a host decode needs it."""
    import subprocess
    code = ('import sys\n'
            'import tpudet_torch.ops.jpeg, tpudet_torch.ops.letterbox\n'
            'import tpudet_torch.tools.serve\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
            '             ("cv2", "triton", "jax", "flax", "tpudet"))\n'
            'assert not bad, bad\n'
            'print("ok")\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


@pytest.mark.parametrize('backend', ['cv2', 'turbojpeg', 'native'])
@pytest.mark.parametrize('name', NAMES)
def test_load_image_from_file_matches_tpudet(native, name, backend):
    """The port's ``LoadImageFromFile`` on the CPU against tpudet's, whose
    ``'turbojpeg'``/``'native'`` backends decode with its libjpeg loader:
    the same pixels and shapes; the truncated file raises in both."""
    from tpudet.data import pipelines as J
    from tpudet_torch.data import pipelines as P
    results = dict(img_info=dict(filename=name), img_prefix=JPEG_DIR)
    ref_load = J.LoadImageFromFile(im_decode_backend=backend)
    load = P.LoadImageFromFile(im_decode_backend=backend, device='cpu')
    if name == jpeg_fixtures.TRUNCATED:
        for fn in (ref_load, load):
            with pytest.raises(FileNotFoundError):
                fn(dict(results))
        return
    ref, got = ref_load(dict(results)), load(dict(results))
    np.testing.assert_array_equal(got['img'], ref['img'])
    for k in ('img_shape', 'ori_shape', 'pad_shape'):
        assert tuple(got[k]) == tuple(ref[k])
    assert got['filename'] == ref['filename']


def test_load_image_on_cuda_reads_other_formats_with_cv2(monkeypatch,
                                                         tmp_path):
    """On a CUDA device a file that is not a JPEG needs cv2; without it the
    read raises and says so."""
    from tpudet_torch.data import pipelines as P
    assert cv2.imwrite(str(tmp_path / 'a.png'), np.zeros((4, 4, 3),
                                                         np.uint8))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'Stream', lambda device: None)
    monkeypatch.setattr(torch.cuda, 'stream',
                        lambda stream: contextlib.nullcontext())
    load = P.LoadImageFromFile(device='cuda')
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match=jpeg.NO_DECODER):
        load(dict(img_info=dict(filename='a.png'), img_prefix=str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        load(dict(img_info=dict(filename='none.jpg'),
                  img_prefix=str(tmp_path)))


def test_decode_image_takes_any_format_and_says_what_it_lacks(monkeypatch):
    """``decode_image``, the one rule the server and ``LoadImageFromFile``
    share: a JPEG through ``decode``, another format through cv2, None for
    bytes that do not decode, and without cv2 an ``ImportError`` that names
    what is missing."""
    data = jpeg_bytes('rgb_96x128.jpg')
    assert torch.equal(jpeg.decode_image(data, 'cpu'),
                       jpeg.decode(data, device='cpu'))
    img = cv2.imread(os.path.join(JPEG_DIR, 'rgb_96x128.jpg'))
    _, png = cv2.imencode('.png', img)
    got = jpeg.decode_image(png.tobytes(), 'cpu')
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), img)
    assert jpeg.decode_image(b'not an image', 'cpu') is None
    assert jpeg.decode_image(jpeg_bytes(jpeg_fixtures.TRUNCATED),
                             'cpu') is None
    monkeypatch.setitem(sys.modules, 'cv2', None)
    for body in (png.tobytes(), data):
        with pytest.raises(ImportError, match=jpeg.NO_DECODER):
            jpeg.decode_image(body, 'cpu')


@pytest.mark.parametrize('status,refused', [
    (0, False), (2, True), (3, True), (4, True), (10, True), (1, None),
    (5, None), (6, None), (7, None), (8, None), (9, None), (1002, None)])
def test_nvjpeg_refuses_bytes_and_raises_on_the_device(monkeypatch, status,
                                                       refused):
    """nvJPEG's statuses through a stubbed shim: those of the bytes
    (INVALID_PARAMETER, BAD_JPEG, JPEG_NOT_SUPPORTED, INCOMPLETE_BITSTREAM)
    are a refused image, None; the others (execution, allocator, internal,
    the shim's 1000 + cudaError) a failure of the device, which raises."""
    class Shim:
        def tpudet_nvjpeg_info(self, handle, data, n, c, css, h, w):
            return status

    nv = jpeg.NvJpeg.__new__(jpeg.NvJpeg)
    nv.lib, nv.handle = Shim(), None
    if refused is None:
        with pytest.raises(RuntimeError, match=f'nvjpegStatus_t {status}'):
            nv.info(b'')
    else:
        assert (nv.info(b'') is None) == refused
        assert jpeg.NvJpeg.decoded(status, 'nvjpegDecode') == (not refused)


def test_letterbox_device_takes_the_index_of_a_bare_cuda(monkeypatch):
    """``device='cuda'`` and images on ``cuda:0`` are one device (the
    default of ``decode_letterbox_batch``, whose nvJPEG decodes lie on
    ``cuda:<current>``)."""
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)

    class OnCard:
        device = torch.device('cuda', 0)

    assert L._device([OnCard(), None], 'cuda') == torch.device('cuda', 0)
    assert L._device([None], 'cuda') == torch.device('cuda', 0)
    assert L._device([None], 'cpu') == torch.device('cpu')
    with pytest.raises(ValueError, match='one device'):
        L._device([OnCard()], 'cpu')
