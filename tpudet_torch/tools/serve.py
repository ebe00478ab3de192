"""Serve a detector over HTTP with dynamic micro-batching: counterpart of
``tools/deployment/serve.py`` (``ModelServer``, ``make_handler``, ``main``).

    python -m tpudet_torch.tools.serve CONFIG [CHECKPOINT] [--model-name
        model] [--port 8080] [--batch 8] [--img-size 640] [--score-thr 0.5]
        [--max-batch-delay 10] [--device cuda|cpu]

CHECKPOINT is a ``*.msgpack`` weights file (tpudet's or the port's
``save_variables``); without it the model takes tpudet's init from numpy
seed 0. The API is TorchServe's, as tpudet's:

- ``GET /ping`` -> ``{"status": "Healthy"}``;
- ``POST /predictions/<model>``, a body of raw image bytes or JSON
  ``{"data": <base64>}`` -> a list of ``{"<class>": [x1, y1, x2, y2],
  "score": s}`` for ``score >= --score-thr``, boxes in the original frame.
  400 for an undecodable image or bad JSON, 404 for an unknown model or
  path, 503 when the request times out.

The hot path, on the device from the bytes on: a dispatcher thread takes up
to ``batch`` requests (or what came within ``max_batch_delay_ms`` of the
first), decodes each JPEG with nvJPEG into a tensor on the card
(``ops/jpeg.py``), letterboxes the batch into the normalised float32 canvas
``(RGB - 114) / 255`` in one launch of the letterbox kernel
(``ops/letterbox.py``), pads it with zeros to the static batch, runs one
``Detector`` call, and brings its four outputs to the host once. A body
that is not a JPEG decodes with cv2 on the host where cv2 is installed and
joins the same launch; without cv2 it gets 400. On the CPU (``device=
'cpu'``) every decode is cv2's and the letterbox its plain version.

On ``cuda`` the server checks at start that nvJPEG loads, and raises if it
does not: it never decodes on the host instead.
"""
from __future__ import annotations

import argparse
import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Optional, Tuple

import numpy as np
import torch

from ..apis.inference import init_detector
from ..ops import jpeg
from ..ops.letterbox import letterbox
from ..utils.device import resolve_device

PAD_VAL = 114
NORM = (114.0, 255.0)  # the YOLO configs' Normalize: mean 114, std 255
NO_DECODER = jpeg.NO_DECODER


class ModelServer:
    """Batched inference core, independent of the HTTP front end."""

    def __init__(self, config, checkpoint: Optional[str] = None,
                 batch: int = 8, img_size: int = 640,
                 score_thr: float = 0.5, max_batch_delay_ms: float = 10.0,
                 device='cuda', dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            jpeg.nvjpeg()  # raises now where libnvjpeg does not load
        self.detector = init_detector(config, checkpoint, device=self.device,
                                      dtype=dtype)
        self.batch = batch
        self.img_size = img_size
        self.score_thr = score_thr
        self.max_batch_delay = max_batch_delay_ms / 1000.0
        self._queue: Queue = Queue()
        self._stop = threading.Event()

        # run the model once at the serving shape before taking traffic
        # (cuDNN picks its algorithms on the first call)
        self._infer(torch.zeros((batch, img_size, img_size, 3),
                                device=self.device),
                    np.ones((batch, 4), np.float32))
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()

    # -- preprocessing ----------------------------------------------------
    def _decode(self, body: bytes) -> torch.Tensor:
        """Image bytes -> (h, w, 3) BGR uint8 tensor on the device; raises
        ``ValueError`` with the client's message, ``RuntimeError`` on a
        failure of the device."""
        try:
            img = jpeg.decode_image(body, self.device)
        except ImportError:
            raise ValueError(NO_DECODER) from None
        if img is None:
            raise ValueError('undecodable image')
        return img

    # -- batching ---------------------------------------------------------
    def submit(self, body: bytes, timeout: float = 30.0):
        """Blocking: enqueue one image, wait for its detections."""
        done = threading.Event()
        slot = {}
        self._queue.put((body, slot, done))
        if not done.wait(timeout):
            raise TimeoutError('inference timed out')
        if 'error' in slot:
            raise ValueError(slot['error'])
        return slot['result']

    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except Empty:
                continue
            items = [first]
            deadline = time.monotonic() + self.max_batch_delay
            while len(items) < self.batch:
                rest = deadline - time.monotonic()
                if rest <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=rest))
                except Empty:
                    break
            self._run_batch(items)

    def _run_batch(self, items):
        images, ok = [], []
        try:
            for body, slot, done in items:
                try:
                    img = self._decode(body)
                except ValueError as e:
                    slot['error'] = str(e)
                    done.set()
                    continue
                images.append(img)
                ok.append((slot, done, tuple(img.shape[:2])))
            if not ok:
                return
            s = self.img_size
            imgs = torch.empty((self.batch, s, s, 3), device=self.device)
            imgs[len(ok):].zero_()
            sfs = np.ones((self.batch, 4), np.float32)
            _, sfs[:len(ok)] = letterbox(images, s, s, PAD_VAL, to_rgb=True,
                                         norm=NORM, out=imgs)
            bboxes, scores, labels, valid = self._infer(imgs, sfs)
        except Exception as e:  # device failure: fail the whole batch
            for _, slot, done in items:
                if not done.is_set():
                    slot['error'] = f'inference failed: {e}'
                    done.set()
            return
        for i, (slot, done, hw) in enumerate(ok):
            slot['result'] = self._format(bboxes[i], scores[i], labels[i],
                                          valid[i], hw)
            done.set()

    def _infer(self, imgs: torch.Tensor, sfs: np.ndarray):
        """One ``Detector`` call on the padded batch; its four outputs on
        the host, fetched together."""
        res = self.detector(imgs, sfs)
        host = [t.to('cpu', non_blocking=True) for t in (
            res.bboxes.float(), res.scores.float(), res.labels, res.valid)]
        if self.device.type == 'cuda':
            torch.cuda.current_stream(self.device).synchronize()
        return [t.numpy() for t in host]

    def _format(self, bboxes, scores, labels, valid,
                hw: Tuple[int, int]):
        """The reference handler's output format (``mmdet_handler.py:
        57-67``); boxes clipped to the original image frame, all of an
        image's boxes (up to ``max_per_img``) in one array op."""
        classes = self.detector.CLASSES
        keep = np.nonzero(valid & (scores >= self.score_thr))[0]
        h, w = hw
        boxes = bboxes[keep].astype(np.float64)
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0.0, float(w))
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0.0, float(h))
        return [{str(classes[int(c)]): box, 'score': float(s)}
                for box, c, s in zip(boxes.tolist(), labels[keep],
                                     scores[keep])]

    def close(self):
        self._stop.set()
        self._dispatcher.join(timeout=2)


def make_handler(server: ModelServer, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/ping':
                self._send(200, {'status': 'Healthy'})
            else:
                self._send(404, {'error': 'not found'})

        def do_POST(self):
            if not self.path.startswith('/predictions/'):
                self._send(404, {'error': 'not found'})
                return
            name = self.path.split('/predictions/', 1)[1].strip('/')
            if name != model_name:
                self._send(404, {'error': f'unknown model {name!r}'})
                return
            length = int(self.headers.get('Content-Length', 0))
            body = self.rfile.read(length)
            ctype = self.headers.get('Content-Type', '')
            if ctype.startswith('application/json'):
                try:
                    body = base64.b64decode(json.loads(body)['data'])
                except (ValueError, KeyError, TypeError):
                    self._send(400, {'error': 'bad json body'})
                    return
            try:
                result = server.submit(body)
            except ValueError as e:
                self._send(400, {'error': str(e)})
                return
            except TimeoutError as e:
                self._send(503, {'error': str(e)})
                return
            self._send(200, result)

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Serve a detector over HTTP')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--model-name', default='model')
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--batch', type=int, default=8,
                   help='static serving batch (one model call a batch)')
    p.add_argument('--img-size', type=int, default=640)
    p.add_argument('--score-thr', type=float, default=0.5,
                   help='reference handler default (mmdet_handler.py:12)')
    p.add_argument('--max-batch-delay', type=float, default=10.0,
                   help='ms to wait filling a batch (TorchServe knob)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    server = ModelServer(args.config, args.checkpoint, batch=args.batch,
                         img_size=args.img_size, score_thr=args.score_thr,
                         max_batch_delay_ms=args.max_batch_delay,
                         device=args.device)
    httpd = ThreadingHTTPServer(('0.0.0.0', args.port),
                                make_handler(server, args.model_name))
    print(f'serving {args.model_name!r} on :{args.port} '
          f'(batch {args.batch}, img {args.img_size}, {server.device})',
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == '__main__':
    main()
