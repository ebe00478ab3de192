"""The letterbox kernel and the nvJPEG decode, on the card.

Marked ``gpu``: skipped where no CUDA device is present. Imports no JAX,
so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest tests/test_torch_jpeg_kernel.py -m gpu

Tolerances: the letterbox kernel equals its plain version (0 levels, the
float canvas 0 ulp); nvJPEG against cv2's committed decode of the fixtures
within the limits PERF.md states (mean |delta| and the share within a band
of levels, by chroma form), the truncated file refused.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from tpudet_torch.ops import jpeg, letterbox as L

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'torch_fixtures', 'jpeg')
# (mean |delta| at most, band of levels, share within the band at least)
LIMITS = {'444': (1.0, 2, 0.99), 'gray': (1.0, 2, 0.99),
          '420': (2.0, 8, 0.985), 'progressive': (2.0, 8, 0.985),
          'restart': (2.0, 8, 0.985)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def _fixtures():
    with open(os.path.join(JPEG_DIR, 'manifest.json')) as f:
        manifest = json.load(f)['fixtures']
    decoded = np.load(os.path.join(JPEG_DIR, 'decoded.npz'))
    out = []
    for name in sorted(manifest):
        with open(os.path.join(JPEG_DIR, name), 'rb') as f:
            data = f.read()
        ref = decoded[name] if name in decoded.files else None
        out.append((name, data, manifest[name]['form'], ref))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize('out', [(640, 640), (416, 320), (7, 5)])
@pytest.mark.parametrize('kw', [dict(pad_val=0), dict(pad_val=114,
                                                      to_rgb=True),
                                dict(pad_val=114, to_rgb=True,
                                     norm=(114.0, 255.0))],
                         ids=['bgr', 'rgb', 'float'])
def test_letterbox_kernel_equals_its_plain_version(out, kw):
    _card()
    gen = torch.Generator(device='cuda').manual_seed(0)
    images = [torch.from_numpy(ref).cuda() for _, _, _, ref in _fixtures()
              if ref is not None]
    images += [torch.randint(0, 256, s, generator=gen, device='cuda',
                             dtype=torch.uint8)
               for s in [(1, 1, 3), (out[0], out[1], 3), (3, 1000, 3)]]
    images.append(None)
    before = L.letterbox.launches
    got, sf = L.letterbox(images, *out, **kw)
    assert L.letterbox.launches == before + 1
    ref, sf_ref = L.letterbox_reference(images, *out, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(sf, sf_ref)


@pytest.mark.gpu
def test_letterbox_splits_a_large_batch_into_launches():
    _card()
    images = [torch.full((5, 7, 3), i, dtype=torch.uint8, device='cuda')
              for i in range(L.MAX_IMAGES + 3)]
    before = L.letterbox.launches
    got, _ = L.letterbox(images, 8, 8)
    assert L.letterbox.launches == before + 2
    ref, _ = L.letterbox_reference(images, 8, 8)
    assert torch.equal(got, ref)


@pytest.mark.gpu
def test_letterbox_refuses_what_the_kernel_does_not_take():
    _card()
    img = torch.zeros((4, 6, 3), dtype=torch.uint8, device='cuda')
    with pytest.raises(ValueError, match='contiguous'):
        L.letterbox([img.transpose(0, 1)], 8, 8)
    with pytest.raises(ValueError, match='uint8'):
        L.letterbox([img.float()], 8, 8)


@pytest.mark.gpu
def test_nvjpeg_decodes_the_fixtures_within_the_limits():
    _card()
    for name, data, form, ref in _fixtures():
        got = jpeg.decode(data, device='cuda')
        if ref is None:
            assert got is None, name
            continue
        assert got is not None and got.is_cuda, name
        diff = (got.cpu().int() - torch.from_numpy(ref).int()).abs()
        mean_max, band, share = LIMITS[form]
        assert float(diff.float().mean()) <= mean_max, name
        assert float((diff <= band).float().mean()) >= share, name


@pytest.mark.gpu
def test_nvjpeg_decodes_queued_behind_work_equal_idle_ones():
    # matmuls queued ahead of each decode keep the stream behind the host,
    # as a loader thread's on a busy card; a decoder state reused before
    # its copies ran gave corrupt images here
    _card()
    datas = [data for _, data, _, ref in _fixtures() if ref is not None]
    want = []
    for data in datas:
        want.append(jpeg.decode(data, device='cuda'))
        torch.cuda.synchronize()
    busy = torch.randn(4096, 4096, device='cuda')
    got = []
    for _ in range(3):
        for data in datas:
            for _ in range(4):
                busy @ busy
            got.append(jpeg.decode(data, device='cuda'))
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        assert torch.equal(g, want[i % len(datas)]), i


@pytest.mark.gpu
def test_nvjpeg_decodes_in_threads_of_their_own():
    _card()
    fixtures = [f for f in _fixtures() if f[3] is not None][:4]
    want = [jpeg.decode(data, device='cuda').cpu() for _, data, _, _ in
            fixtures]
    got = [None] * len(fixtures)

    def work(i):
        got[i] = jpeg.decode(fixtures[i][1], device='cuda')
        torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(fixtures))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [dict(), dict(pad_val=114, bgr=False)],
                         ids=['default', 'rgb_pad114'])
def test_decode_letterbox_on_the_default_device(kw):
    """``decode_letterbox_batch`` and ``decode_letterbox`` at their default
    device (``'cuda'``, no index) against the plain letterbox of nvJPEG's
    own decodes; the truncated file gets status 1, a ``pad_val`` canvas,
    and None from ``decode_letterbox``."""
    _card()
    fixtures = _fixtures()
    datas = [data for _, data, _, _ in fixtures]
    bgr, pad = kw.get('bgr', True), kw.get('pad_val', 0)
    before = L.letterbox.launches
    canvases, sf, status = jpeg.decode_letterbox_batch(datas, 416, 320, **kw)
    assert L.letterbox.launches == before + 1
    decoded = [jpeg.decode(d, bgr=bgr) for d in datas]
    ref, sf_ref = L.letterbox_reference(decoded, 416, 320, pad,
                                        device='cuda')
    assert canvases.is_cuda and torch.equal(canvases, ref)
    np.testing.assert_array_equal(sf, sf_ref)
    np.testing.assert_array_equal(
        status, [int(ref_np is None) for _, _, _, ref_np in fixtures])
    for i, (_, data, _, ref_np) in enumerate(fixtures):
        one = jpeg.decode_letterbox(data, 416, 320, **kw)
        if ref_np is None:
            assert one is None and bool((canvases[i] == pad).all())
            continue
        assert torch.equal(one[0], ref[i])
        np.testing.assert_array_equal(one[1], sf_ref[i])
