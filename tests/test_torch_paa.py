"""PAA in tpudet_torch against tpudet, on the CPU: ``gmm_em_1d``, the
positive mask, the head's losses, gradients and detections, and a float64
train step.

The detector is tpudet's test config (``tests/test_models/test_paa.py``:
ResNet-18, an FPN of 32 channels from c3 with extra convs on the input,
one stacked conv), 5 classes, at 128 px, batches of 2 (the float64 step
at 64 px).

tpudet's EM cannot run under x64 on the head's fp32 candidate losses:
its ``while_loop`` starts fp32 means and returns float64 ones (a
``TypeError``). Where the tests run tpudet under x64 (the EM cases, the
float64 step), its ``gmm_em_1d`` takes its input cast to float64
(``_x64_gmm``): tpudet's own loop, every value float64. The port runs
its EM in the model's dtype, float64 in a float64 model.

Tolerances:

- ``gmm_em_1d``, float64 on both sides, one batch of cases (two clusters,
  masked entries, an early stop, a NaN bound, ties, one valid entry, a
  slower fit, no valid entry; then all cut at 3 iterations) against
  tpudet under ``vmap``: each element's assignment equal, means and
  scores rtol 1e-9 (NaN where tpudet's are); tpudet cut at the port's
  iteration count equals tpudet uncut;
- the positive mask from tpudet's pred maps (fp32 on both sides, EM
  included): equal, index for index, in two gt draws;
- ``loss`` on tpudet's pred maps: each term rtol 1e-5, its gradient with
  respect to the maps rtol 1e-5 (atol 1e-5 of the largest |value|), with
  gts and without;
- ``get_bboxes`` of tpudet's maps: the keeps equal (boxes atol 1e-3 px,
  scores 1e-5), rescaled or not; end to end one-to-one (label, IoU >=
  0.99);
- one train step (SGD, EMA, BatchNorm in train mode) in float64 on both
  sides from tpudet's init: the losses and the gradient norm rtol 1e-4,
  the state within 5e-3 of the change the step made.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models import losses as jlosses
from tpudet.models.dense_heads import paa_head as jpaa
from tpudet_torch.models import losses as tlosses
from tpudet_torch.models.dense_heads import paa_head as tpaa
from tpudet_torch.models.detectors.single_stage import PAA

from .test_models.test_paa import paa_cfg
from .test_torch_atss_gfl import (NUM_CLASSES, assert_loss_and_map_gradients,
                                  assert_maps_close, assert_step_matches,
                                  detector_pair, float64_step, gts,
                                  rescale_kwargs, shipped_test_cfg,
                                  step_batch)
from .test_torch_detector import _np
from .test_torch_retinanet import assert_one_to_one
from .test_torch_roi_head import assert_detections_equal
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

LOSS_KEYS = ('loss_cls', 'loss_bbox', 'loss_iou')
K = 45  # 9 candidates on each of 5 levels


def cfg():
    return shipped_test_cfg(paa_cfg(NUM_CLASSES))


@pytest.fixture
def _x64_gmm(monkeypatch):
    orig = jpaa.gmm_em_1d
    monkeypatch.setattr(jpaa, 'gmm_em_1d', lambda x, valid, **kw: orig(
        x.astype(jnp.float64), valid, **kw))


# the EM

def _gmm_cases():
    """(x (N, K) float64, valid (N, K)), one row a case."""
    rng = np.random.RandomState(0)
    x, valid = np.zeros((8, K)), np.zeros((8, K), bool)

    def put(row, values):
        x[row, :len(values)] = values
        valid[row, :len(values)] = True
    put(0, np.concatenate([rng.normal(0.2, 0.02, 10),
                           rng.normal(2.0, 0.05, 10)]))      # clusters
    put(1, [0.1, 0.2, 5.0])                                  # masked rest
    put(2, np.concatenate([rng.normal(0.0, 0.01, 20),
                           rng.normal(9.0, 0.01, 5)]))       # early stop
    put(3, [0.3, np.nan, 0.5, 0.9])                          # a NaN bound
    put(4, [1.5] * 6 + [0.5] * 6)                            # ties
    put(5, [0.7])                                            # one entry
    put(6, rng.gamma(2.0, 1.0, K))                           # slower
    x[7] = rng.rand(K)                                       # none valid
    return x, valid


def _jax_gmm(x, valid, iters):
    with jax.enable_x64(True):
        out = jax.vmap(jpaa.gmm_em_1d)(jnp.asarray(x), jnp.asarray(valid),
                                       jnp.asarray(iters))
        return [np.asarray(o) for o in out]


def test_gmm_em_matches_tpudet_element_by_element():
    x, valid = _gmm_cases()
    got = tpaa.gmm_em_1d(torch.from_numpy(x), torch.from_numpy(valid))
    ref = _jax_gmm(x, valid, np.full(len(x), 100))
    np.testing.assert_array_equal(got.assign.numpy(), ref[1])
    for g, r in ((got.means, ref[0]), (got.score, ref[2])):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9)
    it = got.iterations.numpy()
    np.testing.assert_array_equal(np.isnan(got.means.numpy()),
                                  np.isnan(ref[0]))
    # the cases stop on their own: early, at a NaN bound, later
    assert it[2] <= 3 and it[3] == 1 and it[6] > it[2] and it.min() >= 1
    assert (ref[1][0, :10] == 0).all() and (ref[1][0, 10:20] == 1).all()
    # tpudet had stopped by the port's count: cut there it is unchanged
    same = _jax_gmm(x, valid, it)
    for a, b in zip(same, ref):
        np.testing.assert_array_equal(a, b)


def test_gmm_em_stops_at_its_cap_as_tpudets():
    x, valid = _gmm_cases()
    got = tpaa.gmm_em_1d(torch.from_numpy(x), torch.from_numpy(valid),
                         iters=3)
    ref = _jax_gmm(x, valid, np.full(len(x), 3))
    np.testing.assert_array_equal(got.assign.numpy(), ref[1])
    np.testing.assert_allclose(got.means.numpy(), ref[0], rtol=1e-9)
    assert got.iterations.max() == 3 and got.iterations[6] == 3


def test_gmm_em_needs_two_iterations_and_keeps_finished_elements():
    """At least 2 iterations (the bounds start at +inf and -inf); an
    element alone and the same element in a batch with slower ones give
    the same result."""
    x, valid = _gmm_cases()
    alone = tpaa.gmm_em_1d(torch.from_numpy(x[2:3]),
                           torch.from_numpy(valid[2:3]))
    batch = tpaa.gmm_em_1d(torch.from_numpy(x), torch.from_numpy(valid))
    assert int(alone.iterations[0]) >= 2
    for a, b in zip(alone, batch):
        np.testing.assert_array_equal(a[0].numpy(), b[2].numpy())


# the head

@pytest.fixture(scope='module')
def pair():
    return detector_pair(cfg(), 20)


def test_pred_maps_match_tpudet(pair):
    _, _, det, _, ref, got = pair
    assert type(det.model) is PAA
    assert_maps_close(got, ref)


def _recorded_positives(monkeypatch, module, run):
    """The positive mask the head hands ``bce_loss`` as its weight."""
    seen = []
    orig = module.bce_loss

    def bce(*args, **kwargs):
        seen.append(np.asarray(kwargs['weight']) > 0)
        return orig(*args, **kwargs)
    monkeypatch.setattr(module, 'bce_loss', bce)
    run()
    monkeypatch.setattr(module, 'bce_loss', orig)
    return seen[-1]


@pytest.mark.parametrize('gt_seed', [21, 24])
def test_positive_mask_equals_tpudets(pair, monkeypatch, gt_seed):
    jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(gt_seed)
    want = _recorded_positives(monkeypatch, jlosses, lambda: jmodel.loss(
        ref, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid)))
    maps = tuple(tuple(torch.tensor(np.asarray(a)) for a in lvls)
                 for lvls in ref)
    got = _recorded_positives(monkeypatch, tlosses, lambda: det.model.loss(
        maps, *(torch.from_numpy(a) for a in (boxes, labels, valid))))
    np.testing.assert_array_equal(got, want)
    # some candidates, not all, kept
    assert 0 < want.sum() < 9 * 5 * valid.sum()


def test_loss_and_gradients_match_tpudet(pair):
    jmodel, _, det, _, ref, _ = pair
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, *gts(21),
                                       LOSS_KEYS)
    assert all(float(tl[k]) > 0 for k in LOSS_KEYS)


def test_loss_without_gts_matches_tpudet(pair):
    jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(22)
    valid[:] = False
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, boxes, labels,
                                       valid, LOSS_KEYS[:1])
    assert float(tl['loss_bbox']) == 0.0


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    jmodel, _, det, _, ref, got = pair
    jkw, tkw = rescale_kwargs() if rescale else ({}, {})
    rj = jax.jit(lambda maps, kw: jmodel.get_bboxes(maps, **kw))(ref, jkw)
    tref = tuple(tuple(torch.tensor(np.asarray(a)) for a in lvls)
                 for lvls in ref)
    rt = det.model.get_bboxes(tref, **tkw)
    assert int(rt.valid.sum(1).min()) >= 10
    assert_detections_equal(rt, rj)
    assert_one_to_one(_np(rj), _np(det.model.get_bboxes(got, **tkw)))


def test_a_train_step_matches_tpudet_in_float64(_x64_gmm):
    state0, jstate, jm, tstate, tm, _ = float64_step(cfg(), step_batch(23))
    assert_step_matches(state0, jstate, jm, tstate, tm, LOSS_KEYS)
    assert jm['loss_iou'] > 0
