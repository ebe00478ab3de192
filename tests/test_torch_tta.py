"""Flip test-time augmentation (``apis/test.py``'s ``tta_get_bboxes`` and
``single_device_test(tta=True)``) and the test CLI's ``--tta`` and
``proposal_fast`` against tpudet's, on the CPU in fp32.

The detector and image sets are ``test_torch_test_flow.py``'s (v4s with a
64-channel neck, 3 classes, 128 px, weights one tpudet tree from a numpy
seed); the CLI runs on ``test_torch_test_cli.py``'s weights file and set.
The merged candidate sets (before the one NMS) agree, boxes within 1e-3
px and scores within that file's 1e-4, and the NMS of tpudet's
candidates is the same in both. The detections pair one-to-one
per image and class (box IoU >= 0.99, scores within 1e-4) but for
near-tied swaps: the plain and the mirrored pass give a near-symmetric
region two mirrored candidates whose scores differ by an ulp or two, which
the two frameworks' fp32 rounding orders either way; the NMS then keeps the
other one, and what it suppresses follows. A detection without a partner
must be explained by the other side's NMS: a detection of its class there
that overlaps it over the NMS threshold and scores no lower than it less
1e-4. At most 1 % of the detections are unpaired. Reports within 1e-6.
The sharded path: explicit shards merge to the one-process results, and
the CLI with two processes (gloo) reports what one process reports.
"""
import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import tpudet.core.nms as jnms
from tpudet.apis.test import single_device_test as j_single_device_test
from tpudet.apis.test import tta_get_bboxes as j_tta_get_bboxes
from tpudet.data import DetDataLoader as JLoader
import tpudet_torch.apis.test as api_test
from tpudet_torch.apis import nms_result_to_per_class, single_device_test
from tpudet_torch.apis.test import merge_sharded_results, tta_get_bboxes
from tpudet_torch.core.nms import NMSResult, batched_nms
from tpudet_torch.tools import test as cli

from .test_torch_dist_cli import _dist, _free_port, _start, _wait
from .test_torch_test_cli import ROOT, _args, setup  # noqa: F401
from .test_torch_test_flow import (CLASSES, IMG, IOU_MIN, NO_RESIZE,
                                   REPORT_ATOL, RESIZE, SCORE_ATOL,
                                   _datasets, _iou, _nms_np,
                                   assert_nms_one_to_one,
                                   no_resize_set, pair,  # noqa: F401
                                   resize_set)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

TIE_SHARE = 0.01


def assert_one_to_one_but_ties(got, ref, iou_thr):
    """Per image and class, the (n, 5) detections pair up one-to-one (box
    IoU >= IOU_MIN, scores within SCORE_ATOL), but for near-tied swaps: an
    unpaired detection has, on the other side, one that overlaps it by
    more than ``iou_thr`` and scores no lower than it less SCORE_ATOL (the
    one that suppressed it there). Returns the detections seen."""
    n = swaps = 0
    for g_img, r_img in zip(got, ref):
        assert len(g_img) == len(r_img)
        for g, r in zip(g_img, r_img):
            assert g.dtype == np.float32 and g.shape[1:] == r.shape[1:]
            n += len(r)
            if not (len(r) and len(g)):
                assert len(r) == len(g)
                continue
            iou = _iou(r[:, :4], g[:, :4])
            close = np.abs(r[:, None, 4] - g[None, :, 4]) <= SCORE_ATOL
            ok = (iou >= IOU_MIN) & close
            used = np.zeros(len(g), bool)
            lost = []
            for i in range(len(r)):
                cand = np.nonzero(ok[i] & ~used)[0]
                if len(cand):
                    used[cand[0]] = True
                else:
                    lost.append(i)
            over = iou > iou_thr
            for i in lost:
                assert (over[i] & (g[:, 4] >= r[i, 4] - SCORE_ATOL)
                        ).any(), f'detection {r[i]} has no match'
            for j in np.nonzero(~used)[0]:
                assert (over[:, j] & (r[:, 4] >= g[j, 4] - SCORE_ATOL)
                        ).any(), f'detection {g[j]} has no match'
            swaps += len(lost) + int((~used).sum())
    assert swaps <= TIE_SHARE * n, (swaps, n)
    return n


def _capture_nms(module, monkeypatch):
    """Make ``module.batched_nms`` return its candidates (boxes, scores)
    instead of running."""
    monkeypatch.setattr(module, 'batched_nms',
                        lambda bbox, scores, *a, **k: (bbox, scores))


def test_tta_get_bboxes_matches_tpudet(pair, resize_set,  # noqa: F811
                                       monkeypatch):
    """tpudet's letterboxed batch (scale factors under 1) through both
    packages' ``tta_get_bboxes``, the batch and its mirror image: the
    merged candidates, the NMS of tpudet's candidates, and the
    detections (tpudet's: its ``batched_nms`` of its candidates, which is
    what its ``tta_get_bboxes`` returns)."""
    jdet, det = pair
    jds, _ = _datasets(resize_set)
    batch = next(iter(JLoader(jds, batch_size=len(RESIZE), max_gts=1,
                              img_size=IMG, shuffle=False, drop_last=False)))
    img, sf = batch['img'], batch['scale_factor']
    assert (sf < 1).any()
    kw = dict(score_thr=0.01, iou_thr=0.6, max_per_img=200)
    j_nms = jnms.batched_nms
    _capture_nms(jnms, monkeypatch)
    j_boxes, j_scores = (np.asarray(a) for a in jax.jit(
        lambda v, x, s: j_tta_get_bboxes(
            jdet.model, v, [x, x[:, :, ::-1]], [s, s], [False, True], **kw))(
        jdet.variables, img, sf))
    monkeypatch.undo()
    ref = jax.jit(lambda b, s: j_nms(b, s, nms_pre=4096, **kw))(j_boxes,
                                                                j_scores)
    t = torch.from_numpy(np.ascontiguousarray(img))
    tsf = torch.from_numpy(sf)

    def port():
        with torch.inference_mode():
            return tta_get_bboxes(det.model, [t, t.flip(2)], [tsf, tsf],
                                  [False, True], **kw)

    got = port()
    assert got.bboxes.shape == (len(RESIZE), 200, 4)
    n = assert_one_to_one_but_ties(
        nms_result_to_per_class(got, len(CLASSES)),
        nms_result_to_per_class(NMSResult(**{
            k: torch.as_tensor(v) for k, v in _nms_np(ref).items()}),
            len(CLASSES)), kw['iou_thr'])
    assert n > 100

    _capture_nms(api_test, monkeypatch)
    boxes, scores = port()
    assert boxes.shape == j_boxes.shape and scores.shape == j_scores.shape
    np.testing.assert_allclose(boxes.numpy(), j_boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=0,
                               atol=SCORE_ATOL)
    monkeypatch.undo()
    same = batched_nms(torch.from_numpy(j_boxes.copy()),
                       torch.from_numpy(j_scores.copy()), nms_pre=4096, **kw)
    assert assert_nms_one_to_one(same, ref) > 100


def test_single_device_test_tta_matches_tpudet(pair,  # noqa: F811
                                               no_resize_set):
    """tpudet's default TTA thresholds (``tta_get_bboxes``'s test above
    sets others)."""
    jdet, det = pair
    jds, ds = _datasets(no_resize_set)
    # one batch: one compile of tpudet's TTA program
    kw = dict(batch_size=len(NO_RESIZE), img_size=IMG, progress=False,
              tta=True)
    ref = j_single_device_test(jdet.model, jdet.variables, jds,
                               process_index=0, process_count=1, **kw)
    got = single_device_test(det.model, ds, **kw)
    assert len(got) == len(ref) == len(NO_RESIZE)
    assert assert_one_to_one_but_ties(got, ref, 0.65) > 50
    plain = single_device_test(det.model, ds, batch_size=2, img_size=IMG,
                               progress=False)
    assert any(not np.array_equal(a, b) for g, p in zip(got, plain)
               for a, b in zip(g, p))


def test_tta_shards_merge_to_the_one_process_results(pair,  # noqa: F811
                                                     no_resize_set):
    _, det = pair
    _, ds = _datasets(no_resize_set)
    kw = dict(batch_size=2, img_size=IMG, progress=False, tta=True)
    full = single_device_test(det.model, ds, **kw)
    merged = merge_sharded_results(
        [single_device_test(det.model, ds, process_index=i,
                            process_count=2, **kw) for i in range(2)],
        len(ds))
    for g, r in zip(merged, full):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def test_tta_refuses_masks_and_infer_fn(pair, no_resize_set):  # noqa: F811
    _, det = pair
    _, ds = _datasets(no_resize_set)
    with pytest.raises(ValueError, match='infer_fn'):
        single_device_test(det.model, ds, tta=True,
                           infer_fn=lambda *a: None)

    class Masked(torch.nn.Module):
        bbox_head = det.model.bbox_head

        def predict_masks(self, img, boxes, valid, feats=None):
            raise AssertionError

    with pytest.raises(ValueError, match='TTA with masks'):
        single_device_test(Masked(), ds, tta=True, with_masks=True)


def test_a_head_without_with_nms_raises():
    """A head whose ``get_bboxes`` takes no ``with_nms`` raises, as in
    tpudet: no TTA is made up for it."""

    class Head(torch.nn.Module):
        num_classes = 1

        def get_bboxes(self, pred_maps, scale_factors=None):
            return pred_maps

    class Model(torch.nn.Module):
        bbox_head = Head()

        def forward(self, img):
            return img

    img = torch.zeros(1, 32, 32, 3)
    sf = torch.ones(1, 4)
    with pytest.raises(TypeError, match='with_nms'):
        tta_get_bboxes(Model(), [img, img.flip(2)], [sf, sf], [False, True])


FLAGS = ['--tta', '--metrics', 'bbox', 'proposal_fast']


def test_cli_tta_proposal_fast_report_matches_tpudet(  # noqa: F811
        setup, monkeypatch, capsys):
    d, cfg_path, ckpt = setup
    ref_args = _args(cfg_path, ckpt, str(d / 'tta_ref.json'),
                     str(d / 'tta_ref')) + FLAGS
    monkeypatch.setattr(sys, 'argv', ['tools/test.py'] + ref_args)
    runpy.run_path(os.path.join(ROOT, 'tools/test.py'), run_name='__main__')
    ref = json.load(open(d / 'tta_ref.json'))
    got = cli.main(_args(cfg_path, ckpt, str(d / 'tta_got.json'),
                         str(d / 'tta_got')) + FLAGS + ['--device', 'cpu'])
    assert list(got) == list(ref) == ['map', 'map50', 'map75', 's_map',
                                      'm_map', 'l_map', 'AR@100', 'AR@300',
                                      'AR@1000']
    for k, v in ref.items():
        assert np.isnan(v) and np.isnan(got[k]) or \
            abs(got[k] - v) <= REPORT_ATOL, k
    assert ref['AR@100'] > 0.5 and ref['map50'] > 0.3
    plain = cli.main([cfg_path, ckpt, '--batch-size', '2', '--img-size',
                      str(IMG), '--device', 'cpu'])
    assert plain['map'] != got['map']
    capsys.readouterr()


def test_cli_tta_proposal_fast_on_two_processes(setup, tmp_path):  # noqa
    """The CLI's multi-process path with both flags: two gloo ranks, the
    report that rank 0 writes equals one process's."""
    _, cfg_path, ckpt = setup
    common = [cfg_path, ckpt, '--img-size', str(IMG), '--batch-size',
              '2'] + FLAGS
    coordinator = f'localhost:{_free_port()}'
    procs = [_start('tpudet_torch.tools.test',
                    common + ['--out', str(tmp_path / f'report{r}.json')] +
                    _dist(r, coordinator)) for r in range(2)]
    outs = _wait(procs)
    one = cli.main(common + ['--device', 'cpu'])
    with open(tmp_path / 'report0.json') as f:
        two = json.load(f)
    assert json.dumps(two, sort_keys=True) == json.dumps(one,
                                                         sort_keys=True)
    assert 'AR@1000' in two and not (tmp_path / 'report1.json').exists()
    assert '"AR@100"' in outs[0] and '"AR@100"' not in outs[1]
