"""The port's server (``tpudet_torch/tools/serve.py``) against tpudet's
(``tools/deployment/serve.py``), and ``async_inference_detector``, on the
CPU.

The tiny model of ``tests/test_runtime/test_serve.py`` (``v4s5p``, 8
classes, 64 px, batch 2), its variables drawn from a numpy seed (the pred
convs wide enough that scores spread), written once with tpudet's
``save_variables`` and read by path by both servers. tpudet's native JPEG
loader is built into a temporary directory (``tests/torch_fixtures``).

Tolerances: the same detections, one to one by class name, scores within
1e-6 (``tests/test_torch_head_nms.py``), boxes within 1e-4 px or, where
larger, 1e-6 of the largest class-offset coordinate of the class-aware NMS
(``box_tol``: its offsets round a box as a coordinate of up to 8 times
the frame; the network's fp32 pred maps differ by a few ulps, which moves
a box by one rounding step there, 2.4e-4 to 9.8e-4 px on these images);
``async_inference_detector`` equal to ``inference_detector``.
"""
import asyncio
import base64
import importlib.util
import json
import os
import sys
import threading
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_fixtures import JPEG_DIR, jpeg_bytes, tpudet_native_jpeg
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.utils.checkpoint import save_variables
from tpudet_torch.apis import (async_inference_detector, inference_detector,
                               init_detector)
from tpudet_torch.tools import serve as S

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, BATCH = 64, 2
CLASSES = [f'class{i}' for i in range(8)]
IMAGES = ['rgb_96x128.jpg', 'rgb_123x457.jpg', 'rgb_480x640.jpg',
          'gray_480x640.jpg', 's444_375x500.jpg', 'progressive_427x640.jpg']


def _tiny_cfg():
    return dict(
        type='SingleStageDetector',
        backbone=dict(type='DarknetCSP', scale='v4s5p',
                      out_indices=[3, 4, 5]),
        neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
                  out_channels=[128, 256, 512], csp_repetition=1),
        bbox_head=dict(type='YOLOCSPHead', num_classes=8,
                       in_channels=[128, 256, 512]),
        test_cfg=dict(min_bbox_size=0, nms_pre=-1, score_thr=0.001,
                      anchor_pre=512, class_pre=64,
                      nms=dict(type='nms', iou_threshold=0.65),
                      max_per_img=20))


def _variables(seed=0):
    jmodel = jax_build_detector(_tiny_cfg())
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        keys = [p.key for p in path]
        shape, name = s.shape, keys[-1]
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            std = 3.0 if keys[2].startswith('conv_pred') else 1.0
            return (rng.randn(*shape) * std / np.sqrt(fan_in)).astype(
                np.float32)
        if name == 'scale':
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


def _load_tpudet_serve():
    spec = importlib.util.spec_from_file_location(
        'tpudet_serve', os.path.join(ROOT, 'tools/deployment/serve.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def servers(tmp_path_factory):
    """tpudet's server and the port's, on the same weights file, and the
    port's behind HTTP on loopback."""
    tmp = tmp_path_factory.mktemp('serve')
    with tpudet_native_jpeg(tmp):
        path = str(tmp / 'tiny.msgpack')
        save_variables(path, _variables(), dict(CLASSES=CLASSES))
        ref = _load_tpudet_serve().ModelServer(
            _tiny_cfg(), path, batch=BATCH, img_size=IMG, score_thr=0.0,
            max_batch_delay_ms=30.0)
        port = S.ModelServer(_tiny_cfg(), path, batch=BATCH, img_size=IMG,
                             score_thr=0.0, max_batch_delay_ms=30.0,
                             device='cpu', dtype=torch.float32)
        httpd = S.ThreadingHTTPServer(('127.0.0.1', 0),
                                      S.make_handler(port, 'yolo'))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            yield ref, port, f'http://127.0.0.1:{httpd.server_address[1]}'
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)
            port.close()
            ref.close()


def _post(url, body, ctype='application/octet-stream'):
    req = urllib.request.Request(url, data=body,
                                 headers={'Content-Type': ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _split(det):
    (name,) = set(det) - {'score'}
    return name, np.array(det[name]), det['score']


def box_tol(dets):
    """1e-4 px, or 1e-6 of the largest coordinate the class-aware NMS
    handles: both packages add ``label * (max coordinate + 1)`` to every
    box before the greedy pass and take it off after, so a box carries the
    rounding of a coordinate up to ``len(CLASSES)`` times the frame."""
    top = max([np.abs(_split(d)[1]).max() for d in dets] + [0.0])
    return max(1e-4, 1e-6 * len(CLASSES) * (top + 1))


def assert_same_detections(ref, got):
    """One to one: the same class name, scores within 1e-6, boxes within
    :func:`box_tol`."""
    assert len(got) == len(ref)
    tol = box_tol(ref)
    used = [False] * len(got)
    for r in ref:
        rn, rb, rs = _split(r)
        for j, g in enumerate(got):
            gn, gb, gs = _split(g)
            if (not used[j] and gn == rn and abs(gs - rs) <= 1e-6
                    and np.abs(gb - rb).max() <= tol):
                used[j] = True
                break
        else:
            raise AssertionError(f'no match for {r} in {got}')


@pytest.mark.parametrize('name', IMAGES)
def test_port_server_returns_tpudets_detections(servers, name):
    ref, port, _ = servers
    body = jpeg_bytes(name)
    want = ref.submit(body)
    got = port.submit(body)
    assert len(want) > 0
    assert_same_detections(want, got)


def test_ping(servers):
    _, _, url = servers
    with urllib.request.urlopen(url + '/ping', timeout=10) as r:
        assert json.loads(r.read()) == {'status': 'Healthy'}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + '/nope', timeout=10)
    assert e.value.code == 404


def test_raw_and_base64_bodies_give_the_submit_result(servers):
    _, port, url = servers
    body = jpeg_bytes('rgb_123x457.jpg')
    want = port.submit(body)
    status, raw = _post(url + '/predictions/yolo', body)
    assert status == 200
    assert_same_detections(want, raw)
    b64 = json.dumps({'data': base64.b64encode(body).decode()}).encode()
    status, got = _post(url + '/predictions/yolo', b64,
                        ctype='application/json')
    assert status == 200
    assert_same_detections(want, got)
    for name in set(want[0]) - {'score'}:
        assert name in CLASSES


def test_concurrent_requests_form_batches(servers, monkeypatch):
    _, port, url = servers
    calls = []
    infer = port._infer

    def counted(imgs, sfs):
        calls.append(imgs.shape[0])
        return infer(imgs, sfs)

    monkeypatch.setattr(port, '_infer', counted)
    n = 6
    results = [None] * n
    bodies = [jpeg_bytes(IMAGES[i % len(IMAGES)]) for i in range(n)]

    def call(i):
        results[i] = _post(url + '/predictions/yolo', bodies[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(st == 200 and isinstance(r, list) for st, r in results)
    assert all(b == BATCH for b in calls)
    assert len(calls) < n


def test_bad_inputs_give_400_and_unknown_names_404(servers):
    _, _, url = servers
    for body in (b'not an image', jpeg_bytes('truncated.jpg')):
        status, err = _post(url + '/predictions/yolo', body)
        assert status == 400 and err['error'] == 'undecodable image'
    status, err = _post(url + '/predictions/yolo', b'{"data": 1',
                        ctype='application/json')
    assert status == 400 and err['error'] == 'bad json body'
    status, err = _post(url + '/predictions/yolo', b'[1]',
                        ctype='application/json')
    assert status == 400 and err['error'] == 'bad json body'
    status, err = _post(url + '/predictions/nope', jpeg_bytes(IMAGES[0]))
    assert status == 404 and 'nope' in err['error']
    status, err = _post(url + '/other', jpeg_bytes(IMAGES[0]))
    assert status == 404


def test_timeout_gives_503(servers, monkeypatch):
    _, port, url = servers

    def late(body, timeout=30.0):
        raise TimeoutError('inference timed out')

    monkeypatch.setattr(port, 'submit', late)
    status, err = _post(url + '/predictions/yolo', jpeg_bytes(IMAGES[0]))
    assert status == 503 and err['error'] == 'inference timed out'


def test_boxes_lie_in_the_original_frame(servers):
    _, port, _ = servers
    for name in IMAGES:
        h, w = cv2.imread(os.path.join(JPEG_DIR, name)).shape[:2]
        for det in port.submit(jpeg_bytes(name)):
            _, (x1, y1, x2, y2), _ = _split(det)
            assert 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h


def test_png_body_decodes_with_cv2_and_needs_it(servers, monkeypatch):
    _, port, url = servers
    img = cv2.imread(os.path.join(JPEG_DIR, 'rgb_96x128.jpg'))
    ok, png = cv2.imencode('.png', img)
    assert ok
    status, result = _post(url + '/predictions/yolo', png.tobytes())
    assert status == 200 and isinstance(result, list)
    monkeypatch.setitem(sys.modules, 'cv2', None)
    status, err = _post(url + '/predictions/yolo', png.tobytes())
    assert status == 400 and err['error'] == S.NO_DECODER


@pytest.mark.parametrize('stage', ['infer', 'decode'])
def test_a_device_failure_fails_the_whole_batch(servers, monkeypatch, stage):
    """A failure of the device, in the model call or in a decode (nvJPEG's
    execution errors raise), fails every request of the batch, the ones
    already decoded too, and the dispatcher serves on."""
    _, port, _ = servers
    bodies = [jpeg_bytes(IMAGES[0]), jpeg_bytes(IMAGES[1])]

    def broken(*args):
        raise RuntimeError('device lost')

    with monkeypatch.context() as m:
        if stage == 'infer':
            m.setattr(port, '_infer', broken)
        else:
            decode_image = S.jpeg.decode_image
            m.setattr(S.jpeg, 'decode_image', lambda data, device: (
                broken() if data == bodies[1] else decode_image(data,
                                                                device)))
        items = [(b, {}, threading.Event()) for b in bodies]
        port._run_batch(items)
        for _, slot, done in items:
            assert done.is_set()
            assert slot == {'error': 'inference failed: device lost'}
        with pytest.raises(ValueError, match='inference failed: device'):
            port.submit(bodies[1])
    assert isinstance(port.submit(bodies[1]), list)


def test_server_defaults_to_cuda_and_needs_nvjpeg(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.ModelServer(_tiny_cfg())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)

    def no_library():
        raise OSError('libnvjpeg.so.12: cannot open shared object file')

    monkeypatch.setattr(S.jpeg, 'nvjpeg', no_library)
    with pytest.raises(OSError, match='libnvjpeg'):
        S.ModelServer(_tiny_cfg())


def test_cli_parses_tpudets_flags():
    args = S.parse_args(['cfg.py', 'w.msgpack', '--model-name', 'm',
                         '--port', '0', '--batch', '4', '--img-size', '320',
                         '--score-thr', '0.3', '--max-batch-delay', '5'])
    assert (args.config, args.checkpoint, args.model_name, args.port,
            args.batch, args.img_size, args.score_thr,
            args.max_batch_delay, args.device) == (
        'cfg.py', 'w.msgpack', 'm', 0, 4, 320, 0.3, 5.0, 'cuda')


@pytest.fixture(scope='module')
def detector():
    return init_detector(dict(_tiny_cfg(), test_cfg=dict(
        _tiny_cfg()['test_cfg'])), variables=_variables(), device='cpu',
        dtype=torch.float32, classes=CLASSES)


@pytest.mark.parametrize('source', ['array', 'path'])
def test_async_inference_detector_equals_inference_detector(detector,
                                                            source):
    path = os.path.join(JPEG_DIR, 'rgb_123x457.jpg')
    img = cv2.imread(path) if source == 'array' else path
    want = inference_detector(detector, img, pad_to=IMG)
    got = asyncio.run(async_inference_detector(detector, img, pad_to=IMG))
    assert len(got) == len(want) == 8
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
