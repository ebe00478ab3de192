"""The whole inference slice: tpudet_torch's ``init_detector`` against
tpudet's detector, on the CPU in fp32.

YOLOv4 at the v4s scale, 128 px, 4 classes, the shipped ``test_cfg`` with
``anchor_pre=256`` so that the objectness prefilter runs (at 128 px there
are 1,008 anchors, under the shipped 2,048). One tpudet variables tree
from a numpy seed feeds both; the head's pred convs are drawn wide enough
that scores clear ``score_thr``.

Tolerances: pred maps max |delta| <= 1e-4 * max |ref|; detections match
one-to-one, by label and box IoU >= 0.99, with scores within 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.config import Config as JaxConfig
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet_torch.apis import init_detector

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, NUM_CLASSES = 128, 4


def _model_cfg():
    cfg = JaxConfig.fromfile(
        os.path.join(ROOT, 'configs/yolov4/yolov4s_coco_mosaic.py'))
    model = dict(cfg['model'])
    model['bbox_head'] = dict(model['bbox_head'], num_classes=NUM_CLASSES)
    model['test_cfg'] = dict(model['test_cfg'], anchor_pre=256)
    return model


def _variables(jmodel, seed):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        keys = [p.key for p in path]
        shape, name = s.shape, keys[-1]
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            std = (3.0 if keys[2].startswith('conv_pred') else 1.0)
            return (rng.randn(*shape) * std / np.sqrt(fan_in)).astype(
                np.float32)
        if name == 'scale':
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], axis=-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def assert_one_to_one(ref, got, iou_min=0.99, score_atol=1e-4):
    """Per image: the valid detections pair up one-to-one, same label,
    IoU >= iou_min, scores within score_atol."""
    for i in range(ref['valid'].shape[0]):
        rv, gv = ref['valid'][i], got['valid'][i]
        assert rv.sum() == gv.sum()
        rb, gb = ref['bboxes'][i][rv], got['bboxes'][i][gv]
        rl, gl = ref['labels'][i][rv], got['labels'][i][gv]
        rs, gs = ref['scores'][i][rv], got['scores'][i][gv]
        ok = (_iou(rb, gb) >= iou_min) & (rl[:, None] == gl[None, :]) & (
            np.abs(rs[:, None] - gs[None, :]) <= score_atol)
        used = np.zeros(len(gb), bool)
        for r in range(len(rb)):
            cand = np.nonzero(ok[r] & ~used)[0]
            assert len(cand), f'image {i}: detection {r} has no match'
            used[cand[0]] = True


def _np(res):
    return {k: np.asarray(v) for k, v in res._asdict().items()}


@pytest.fixture(scope='module')
def pair():
    cfg = _model_cfg()
    jmodel = jax_build_detector(cfg)
    variables = _variables(jmodel, seed=0)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    img = np.random.RandomState(1).uniform(
        -0.45, 0.55, (2, IMG, IMG, 3)).astype(np.float32)
    return jmodel, variables, det, img


def test_pred_maps_match_tpudet(pair):
    jmodel, variables, det, img = pair
    ref = jmodel.apply(variables, jnp.asarray(img))
    got = det.forward(img)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        assert float(np.abs(g.numpy() - r).max() / np.abs(r).max()) <= 1e-4


def test_detections_match_tpudet(pair):
    jmodel, variables, det, img = pair
    ref = _np(jmodel.get_bboxes(jmodel.apply(variables, jnp.asarray(img))))
    got = _np(det(img))
    assert got['bboxes'].shape == (2, 300, 4)
    assert ref['valid'].sum() > 20
    assert_one_to_one(ref, got)


def test_scale_factor_rescales(pair):
    _, _, det, img = pair
    sf = np.full((2, 4), 2.0, np.float32)
    plain, scaled = det(img), det(img, scale_factor=sf)
    assert torch.equal(plain.valid, scaled.valid)
    torch.testing.assert_close(scaled.bboxes, plain.bboxes / 2)


def test_init_detector_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_detector(_model_cfg())


def test_init_detector_reads_the_shipped_config_file():
    """The flagship config file and its _base_ build through the port's
    own Config, with tpudet's init from numpy seed 0 (at v4s to stay
    small)."""
    det = init_detector(
        os.path.join(ROOT, 'configs/yolov4/yolov4s_coco_mosaic.py'),
        device='cpu', dtype=torch.float32)
    assert det.cfg['model']['test_cfg']['lane_pre'] == 4
    res = det(np.zeros((1, 64, 64, 3), np.float32))
    assert res.bboxes.shape == (1, 300, 4) and res.labels.shape == (1, 300)
