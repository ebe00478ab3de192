"""The port's drawing (``tpudet_torch/visualization.py``), its demos
(``tpudet_torch/demo/``) and its dataset tools (``browse_dataset``,
``eval_metric``, ``analyze_results``) against cv2 and tpudet, on the CPU.

- ``draw_rectangle`` equals ``cv2.rectangle`` bit for bit, thickness 1 and
  2 (and 3, 4), on 2,000 boxes a thickness from numpy seeds: inside, across
  the border and wholly outside the image, reversed corners, points and
  lines.
- ``add_weighted`` equals ``cv2.addWeighted`` on uint8 bit for bit, on all
  256 x 256 input pairs at alpha 0.45 and 0.55.
- ``imshow_det_bboxes`` and ``imshow_gt_det_bboxes`` (boxes from float
  coordinates, polygon and RLE masks) equal tpudet's bit for bit outside
  each label's box, the box ``cv2.getTextSize`` gives tpudet's label
  widened by 1 px on each side (Hershey's 'j' reaches 1 px left of its
  origin); inside it, every pixel is the background (the same drawing
  without labels) or the label's class colour. The label font stays in
  that box for every printable character.
- The PNG writer's file reads back through ``cv2.imread`` and ``read_png``
  equal to the array; another suffix without cv2 raises ``ImportError``.
- A file given with no ``device`` is decoded on ``cuda``: with no card
  the drawing functions raise.
- ``image_demo`` prints tpudet's lines on the same weights file, and its
  ``--out-file`` equals tpudet's outside the labels; ``video_demo`` reads a
  3-frame MJPG AVI that cv2 writes here; both video demos raise
  ``ImportError`` without cv2 before they build a model; the three tools
  write what tpudet's write (``browse_dataset``'s images bit-equal,
  ``eval_metric``'s report equal, ``analyze_results``' files of the same
  names).
"""
import copy
import json
import os
import pickle
import runpy
import string
import sys

import cv2
import numpy as np
import pytest
import torch

import tpudet.visualization as jvis
from tpudet.config import Config as JConfig
from tpudet.core.mask import encode_rle as j_encode_rle
from tpudet.models.builder import build_detector as j_build_detector
from tpudet.utils.checkpoint import save_variables as j_save_variables
from tpudet_torch import visualization as vis
from tpudet_torch.data import pipelines
from tpudet_torch.demo import image_demo, video_demo, webcam_demo
from tpudet_torch.tools import analyze_results, browse_dataset, eval_metric
from tpudet_torch.tools import dataset_formats as formats

from .test_torch_datasets import SHAPES, _coco
from .test_torch_test_flow import (CLASSES, IMG, NO_RESIZE, _cfg,
                                   _variables, _write_set)
from . import torch_fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT = cv2.FONT_HERSHEY_SIMPLEX


@pytest.mark.parametrize('thickness', [1, 2, 3, 4])
def test_draw_rectangle_equals_cv2(thickness):
    rng = np.random.RandomState(thickness)
    for i in range(2000):
        h, w = rng.randint(1, 48, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        span = [(-5, 55), (-80, 130), (-3000, 3000)][i % 3]
        x1, y1, x2, y2 = (int(v) for v in rng.randint(*span, 4))
        if i % 7 == 0:
            x2 = x1  # a vertical line, or with y2 == y1 a point
        if i % 11 == 0:
            y2 = y1
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        ref = img.copy()
        cv2.rectangle(ref, (x1, y1), (x2, y2), color, thickness)
        got = vis.draw_rectangle(img.copy(), (x1, y1), (x2, y2), color,
                                 thickness)
        np.testing.assert_array_equal(got, ref, err_msg=str(
            (h, w, x1, y1, x2, y2)))


@pytest.mark.parametrize('alpha', [0.45, 0.55])
def test_add_weighted_equals_cv2_on_every_pair(alpha):
    x = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    y = np.ascontiguousarray(x.T)
    for a, b in ((x, y), (np.dstack([x, y, x]), np.dstack([y, x, y]))):
        ref = b.copy()
        cv2.addWeighted(a, alpha, b, 1 - alpha, 0, ref)
        np.testing.assert_array_equal(vis.add_weighted(a, alpha, b,
                                                       1 - alpha, 0), ref)


def test_palette_is_tpudets():
    assert vis._palette(80) == jvis._palette(80)
    assert vis._palette(0) == jvis._palette(0)


@pytest.mark.parametrize('font_scale', [0.5, 1.0])
def test_label_font_stays_in_the_cv2_text_box(font_scale):
    rng = np.random.RandomState(0)
    chars = string.printable[:95]
    texts = list(chars) + [c * 6 for c in chars] + [
        ''.join(rng.choice(list(chars), rng.randint(1, 24)))
        for _ in range(300)] + ['person: 0.93', 'gt: traffic light']
    for text in texts:
        img = np.zeros((120, 900), np.uint8)
        vis.draw_text(img, text, (30, 80), 255, font_scale)
        (w, h), base = cv2.getTextSize(text, FONT, font_scale, 1)
        ys, xs = np.nonzero(img)
        if text.strip():
            assert len(xs), text
        if len(xs):
            assert xs.min() >= 30 and xs.max() <= 30 + w, text
            assert ys.min() >= 80 - h and ys.max() <= 80 + base, text


def _label_regions(labels, shape, offset=0):
    """(mask of every label box, [(box slices, colour)]) for labels
    ``[(text, (x, y) origin, colour, font_scale)]``: the ``getTextSize``
    box widened by 1 px."""
    inside = np.zeros(shape[:2], bool)
    regions = []
    for text, (x, y), color, fs in labels:
        (w, h), base = cv2.getTextSize(text, FONT, fs, 1)
        x = x + offset
        sl = (slice(max(y - h - 1, 0), max(y + base + 2, 0)),
              slice(max(x - 1, 0), max(x + w + 2, 0)))
        inside[sl] = True
        regions.append((sl, color))
    return inside, regions


def assert_equal_but_labels(got, ref, background, labels, offset=0):
    inside, regions = _label_regions(labels, ref.shape, offset)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got[~inside], ref[~inside])
    assert (got[~inside] != 0).any()
    for sl, color in regions:
        g, b = got[sl], background[sl]
        ok = (g == b).all(-1) | (g == np.asarray(color, np.uint8)).all(-1)
        assert ok.all(), 'a label pixel is neither background nor colour'
    # the labels were drawn, somewhere
    assert (got != background).any()


def _layout(seed, n_cls=3, per_cls=2):
    """Detections on a grid far enough apart that no box, mask or label
    reaches another's label; float corners, some scores under 0.3; masks
    as polygons (class 0), RLEs (class 1) and bitmaps (class 2)."""
    rng = np.random.RandomState(seed)
    h, w = 220, 420
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    dets, segms, labels = [], [], []
    k = 0
    for c in range(n_cls):
        arr, masks = [], []
        for j in range(per_cls):
            col, row = k % 3, k // 3
            x1 = 12.7 + 140 * col + rng.uniform(0, 3)
            y1 = 24.3 + 105 * row + rng.uniform(0, 3)
            x2, y2 = x1 + rng.uniform(40, 90), y1 + rng.uniform(30, 60)
            score = [0.95, 0.2, 0.31][k % 3]
            arr.append([x1, y1, x2, y2, score])
            bitmap = np.zeros((h, w), np.uint8)
            bitmap[int(y1) + 3:int(y2) - 3, int(x1) + 3:int(x2) - 3] = 1
            if c == 0:
                masks.append([[x1 + 4, y1 + 4, x2 - 4, y1 + 6, x2 - 6,
                               y2 - 4, x1 + 5, y2 - 8]])
            elif c == 1:
                masks.append(j_encode_rle(bitmap))
            else:
                masks.append(bitmap)
            k += 1
        dets.append(np.array(arr, np.float32))
        segms.append(masks)
    return img, dets, segms


def _det_labels(dets, names, thr, fs=0.5):
    colors = jvis._palette(len(names))
    return [(f'{names[c]}: {d[4]:.2f}', (int(d[0]), max(int(d[1]) - 4, 0)),
             colors[c], fs)
            for c, arr in enumerate(dets) for d in arr if d[4] >= thr]


@pytest.fixture
def no_labels(monkeypatch):
    """Draw without labels (the background of the label boxes)."""

    def render(fn, *args, **kw):
        with monkeypatch.context() as m:
            m.setattr(vis, 'draw_text', lambda img, *a, **k: img)
            return fn(*args, **kw)
    return render


@pytest.mark.parametrize('with_masks', [False, True])
@pytest.mark.parametrize('thickness', [1, 2])
def test_imshow_det_bboxes_matches_tpudet(no_labels, with_masks, thickness):
    img, dets, segms = _layout(0)
    names = ('cat', 'jellyfish', 'bird')
    result = (dets, segms) if with_masks else dets
    kw = dict(score_thr=0.3, thickness=thickness)
    ref = jvis.imshow_det_bboxes(img.copy(), result, names, **kw)
    got = vis.imshow_det_bboxes(img.copy(), result, names, **kw)
    background = no_labels(vis.imshow_det_bboxes, img.copy(), result, names,
                           **kw)
    assert_equal_but_labels(got, ref, background,
                            _det_labels(dets, names, 0.3))
    if with_masks:
        plain = vis.imshow_det_bboxes(img.copy(), dets, names, **kw)
        assert (plain != got).any()


def test_imshow_gt_det_bboxes_matches_tpudet(no_labels):
    img, dets, segms = _layout(1)
    names = ('cat', 'dog', 'bird')
    boxes = np.concatenate(dets)[:, :4]
    ann = dict(gt_bboxes=boxes, gt_labels=np.repeat(np.arange(3), 2),
               gt_masks=[s if not isinstance(s, np.ndarray) else None
                         for arr in segms for s in arr])
    ref = jvis.imshow_gt_det_bboxes(img.copy(), ann, dets, names)
    got = vis.imshow_gt_det_bboxes(img.copy(), ann, dets, names)
    background = no_labels(vis.imshow_gt_det_bboxes, img.copy(), ann, dets,
                           names)
    colors = jvis._palette(3)
    gt_labels = [(f'gt: {names[c]}', (int(b[0]), max(int(b[1]) - 4, 0)),
                  colors[c], 0.5) for b, c in zip(boxes, ann['gt_labels'])]
    inside_gt, _ = _label_regions(gt_labels, img.shape)
    w = img.shape[1]
    assert_equal_but_labels(got[:, :w], ref[:, :w], background[:, :w],
                            gt_labels)
    assert_equal_but_labels(got[:, w:], ref[:, w:], background[:, w:],
                            _det_labels(dets, names, 0.3))
    assert inside_gt.any()


def test_png_writer_round_trips(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    path = str(tmp_path / 'x.png')
    vis.write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)
    np.testing.assert_array_equal(vis.read_png(path), img)
    out = vis.imshow_det_bboxes(img.copy(), [np.zeros((0, 5), np.float32)],
                                ('a',), out_file=str(tmp_path / 'y.PNG'))
    np.testing.assert_array_equal(vis.read_png(str(tmp_path / 'y.PNG')), out)
    cv2.imwrite(str(tmp_path / 'z.png'), img)  # filtered rows: refused
    with pytest.raises(ValueError):
        vis.read_png(str(tmp_path / 'z.png'))
    with pytest.raises(ValueError):
        vis.write_png(path, img[..., 0])


def test_other_suffixes_need_cv2(tmp_path, monkeypatch):
    img = np.zeros((8, 8, 3), np.uint8)
    vis.write_image(str(tmp_path / 'a.jpg'), img)
    assert cv2.imread(str(tmp_path / 'a.jpg')).shape == (8, 8, 3)
    monkeypatch.setitem(sys.modules, 'cv2', None)
    assert not vis.has_cv2()
    with pytest.raises(ImportError, match=r'cv2.*\.png'):
        vis.write_image(str(tmp_path / 'b.jpg'), img)
    assert not (tmp_path / 'b.jpg').exists()
    for demo in (video_demo, webcam_demo):
        args = ['missing_cfg.py', '--device', 'cpu']
        if demo is video_demo:
            args = ['missing.avi'] + args
        with pytest.raises(ImportError, match='cv2'):
            demo.main(args)


def test_a_path_is_decoded_on_the_card_by_default(tmp_path, monkeypatch):
    """Given a file and no ``device``, both drawing functions decode it
    on ``cuda``: with no card that raises; with one (stood in for here by
    a loader that records the device it was asked for and reads on the
    CPU) the drawing equals the one of the decoded array."""
    img, dets, _ = _layout(0)
    path = str(tmp_path / 'a.png')
    cv2.imwrite(path, img)
    names = ('a', 'b', 'c')
    ann = dict(gt_bboxes=np.concatenate(dets)[:, :4],
               gt_labels=np.repeat(np.arange(3), 2))
    draws = ((vis.imshow_det_bboxes, (dets, names)),
             (vis.imshow_gt_det_bboxes, (ann, dets, names)))
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, 'is_available', lambda: False)
        for fn, args in draws:
            with pytest.raises(RuntimeError, match='no CUDA device'):
                fn(path, *args)
    asked = []

    class Recording(pipelines.LoadImageFromFile):

        def __init__(self, *a, device, **kw):
            asked.append(str(device))
            super().__init__(*a, device='cpu', **kw)

    monkeypatch.setattr(pipelines, 'LoadImageFromFile', Recording)
    for fn, args in draws:
        np.testing.assert_array_equal(fn(path, *args), fn(img.copy(), *args))
    assert asked == ['cuda', 'cuda']


# ---------------------------------------------------------------------------
# the demos and tools, on one weights file and one config
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """A config (``test_torch_test_flow.py``'s detector, its no-resize set
    as ``data.test`` and, with a fixed pipeline, ``data.train``), tpudet's
    weights file of it, and the shapes val set as a VOC tree."""
    d = _write_set(tmp_path_factory.mktemp('vis_set'), NO_RESIZE, 0)
    cfg = _cfg()
    test = dict(type='CocoDataset', ann_file=str(d / 'ann.json'),
                img_prefix=str(d), classes=CLASSES,
                pipeline=cfg['data']['test']['pipeline'])
    train = dict(test, pipeline=[
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations', with_bbox=True),
        dict(type='Resize', img_scale=(96, 96), keep_ratio=True),
        dict(type='Pad', size_divisor=32),
        dict(type='Normalize', mean=[114, 114, 114], std=[255, 255, 255],
             to_rgb=True)])
    cfg_path = d / 'cfg.py'
    cfg_path.write_text(f'model = {cfg["model"]!r}\n'
                        f'data = dict(test={test!r}, train={train!r})\n')
    # the demo's: the image resized to fill inference_detector's 640
    # canvas (a padded canvas gives its constant region's anchors
    # near-tied scores, which the two frameworks order either way)
    demo_test = copy.deepcopy(test)
    demo_test['pipeline'][1]['img_scale'] = (640, 640)
    (d / 'demo_cfg.py').write_text(f'model = {cfg["model"]!r}\n'
                                   f'data = dict(test={demo_test!r})\n')
    jmodel = j_build_detector(JConfig.fromfile(str(cfg_path))['model'])
    ckpt = str(d / 'weights.msgpack')
    j_save_variables(ckpt, _variables(jmodel), meta=dict(
        CLASSES=list(CLASSES)))
    voc = formats.write_voc(_coco(), f'{SHAPES}/val/images', str(d / 'voc'),
                            difficult=lambda a: a['id'] % 5 == 0)
    voc_cfg = d / 'voc_cfg.py'
    voc_cfg.write_text('data = dict(test=dict(type="VOCDataset", '
                       f'ann_file={voc!r}, img_prefix={str(d / "voc")!r}, '
                       f'classes=("rect", "circle", "triangle"), '
                       f'pipeline={cfg["data"]["test"]["pipeline"]!r}))\n')
    return d, str(cfg_path), ckpt, str(voc_cfg)


def _run_tpudet(script, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [script] + argv)
    runpy.run_path(os.path.join(ROOT, script), run_name='__main__')


def test_image_demo_prints_tpudets_lines(setup, monkeypatch, capsys):
    d, _, ckpt, _ = setup
    img = str(d / '0.jpg')
    args = [img, str(d / 'demo_cfg.py'), ckpt, '--score-thr', '0.3']
    _run_tpudet('demo/image_demo.py',
                args + ['--out-file', str(d / 'ref.png')], monkeypatch)
    ref = capsys.readouterr().out.splitlines()
    with torch_fixtures.default_threads():  # mirrored boxes' near-ties
        result = image_demo.main(args + ['--out-file', str(d / 'got.png'),
                                         '--device', 'cpu'])
    got = capsys.readouterr().out.splitlines()
    assert got == ref and len(ref) > 3
    assert ref[-1] == f'{len(ref) - 1} detections above 0.3'

    drawn = vis.read_png(str(d / 'got.png'))
    np.testing.assert_array_equal(cv2.imread(str(d / 'got.png')), drawn)
    names = CLASSES
    labels = _det_labels(result, names, 0.3)
    inside, _ = _label_regions(labels, drawn.shape)
    ref_img = cv2.imread(str(d / 'ref.png'))
    np.testing.assert_array_equal(drawn[~inside], ref_img[~inside])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        image_demo.main(args)


def test_video_demo_reads_an_avi(setup, tmp_path, capsys):
    d, cfg_path, ckpt, _ = setup
    path = str(tmp_path / 'clip.avi')
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 5,
                             (128, 128))
    if not writer.isOpened():
        pytest.skip("this cv2 has no video writer backend for MJPG AVI")
    frame = cv2.imread(str(d / '0.jpg'))
    for f in (frame, frame[:, ::-1], frame[::-1]):
        writer.write(np.ascontiguousarray(f))
    writer.release()
    n = video_demo.main([path, cfg_path, ckpt, '--device', 'cpu',
                         '--out', str(tmp_path / 'out.mp4')])
    assert n == 3


def test_browse_dataset_writes_tpudets_images(setup, tmp_path, monkeypatch,
                                              capsys):
    _, cfg_path, _, _ = setup
    _run_tpudet('tools/misc/browse_dataset.py',
                [cfg_path, '--output-dir', str(tmp_path / 'ref'),
                 '--num', '3'], monkeypatch)
    paths = browse_dataset.main([cfg_path, '--output-dir',
                                 str(tmp_path / 'got'), '--num', '3',
                                 '--device', 'cpu'])
    assert [os.path.basename(p) for p in paths] == ['0.jpg', '1.jpg',
                                                    '2.jpg']
    for p in paths:
        ref = cv2.imread(str(tmp_path / 'ref' / os.path.basename(p)))
        np.testing.assert_array_equal(cv2.imread(p), ref)
    out = capsys.readouterr().out
    assert out.count('wrote 3 images to') == 2


def test_eval_metric_reports_as_tpudet(setup, tmp_path, monkeypatch,
                                       capsys):
    _, _, _, voc_cfg = setup
    rng = np.random.RandomState(0)
    results = []
    for _ in range(32):
        per_cls = []
        for _ in range(3):
            xy = rng.uniform(0, 250, (6, 2))
            per_cls.append(np.concatenate(
                [xy, xy + rng.uniform(20, 90, (6, 2)),
                 rng.uniform(0, 1, (6, 1))], 1).astype(np.float32))
        results.append(per_cls)
    path = str(tmp_path / 'results.pkl')
    with open(path, 'wb') as f:
        pickle.dump(results, f)
    _run_tpudet('tools/analysis_tools/eval_metric.py', [voc_cfg, path],
                monkeypatch)
    ref = capsys.readouterr().out
    got = eval_metric.main([voc_cfg, path, '--device', 'cpu'])
    assert capsys.readouterr().out == ref
    assert json.dumps(json.loads(ref)) == json.dumps(got) and got['map'] > 0
    with open(path, 'wb') as f:
        pickle.dump(results[:3], f)
    with pytest.raises(ValueError, match='3 results vs 32 images'):
        eval_metric.main([voc_cfg, path, '--device', 'cpu'])


def test_analyze_results_writes_tpudets_files(setup, tmp_path, monkeypatch,
                                              capsys):
    _, cfg_path, ckpt, _ = setup
    # one batch: one compile of tpudet's program
    common = [cfg_path, ckpt, '--topk', '2', '--batch-size',
              str(len(NO_RESIZE)), '--img-size', str(IMG), '--score-thr',
              '0.5']
    _run_tpudet('tools/analysis_tools/analyze_results.py',
                common + ['--show-dir', str(tmp_path / 'ref')], monkeypatch)
    scores = analyze_results.main(common + ['--show-dir',
                                            str(tmp_path / 'got'),
                                            '--device', 'cpu'])
    assert len(scores) == len(NO_RESIZE)
    for kind in ('good', 'bad'):
        names = sorted(os.listdir(tmp_path / 'ref' / kind))
        assert sorted(os.listdir(tmp_path / 'got' / kind)) == names
        assert len(names) == 2
        for n in names:
            assert cv2.imread(str(tmp_path / 'got' / kind / n)).shape == \
                cv2.imread(str(tmp_path / 'ref' / kind / n)).shape
    assert 'saved 4 visualizations under' in capsys.readouterr().out
