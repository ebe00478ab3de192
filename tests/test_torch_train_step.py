"""The training slice as a whole: tpudet_torch's train step against
tpudet's ``make_train_step`` on the CPU, in fp32.

YOLOv4 at the v4s scale and YOLOv5 at the v5s scale (each fixture and test
runs for both), with narrow necks, 64 px, 4 classes, batches of 4
images split into 2 micro-batches, a warm-up of 3 steps (so both steps run
inside it, with the bias LR above the weight LR), gradient clipping at
norm 10 (so it clips), EMA warm-up 4 (so the second step blends). One
tpudet ``TrainState`` from tpudet's own init, with every BatchNorm scale
at 0.25, feeds both sides through ``flax_import``; the batches come from a
numpy seed. The inputs have no ties in the max-pools or the losses'
max/clip.

Why BN scale 0.25: at tpudet's init (scale 1) the random network is
chaotic. fp32 reassociation alone (the port on 1 CPU thread against 8)
then moves the second step's gradient norm by 5e-4, over the tolerance;
at 0.25 the same comparison moves it by 2e-6.

Tolerances: losses and the gradient norm rtol 1e-4 at every step; params,
BN statistics, EMA copies and momentum buffers within 5e-3 of the largest
change the two steps made to them (the yardstick of
``__graft_entry__.py:130-146``): fp32 sums run in other orders in the two
frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step
from tpudet_torch.apis import init_trainer
from tpudet_torch.config import Config
from tpudet_torch.models.builder import build_detector
from tpudet_torch.train.optim import YoloSGDConfig
from tpudet_torch.train.train_state import make_train_step
from tpudet_torch.utils.flax_import import (train_state_from_flax,
                                            train_state_to_flax)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG, NUM_CLASSES, BATCH, ACCUM, STEPS = 64, 4, 4, 2, 2
OPT = dict(lr=0.01, total_steps=50, warmup_iters=3, steps_per_epoch=0,
           grad_clip_norm=10.0)
BN_SCALE = 0.25
EMA = dict(ema_momentum_base=0.9999, ema_warm_up=4, ema_interval=1)


def tiny_cfg(model='v4s'):
    if model == 'v5s':  # the v5 neck keeps the backbone's finest width
        return dict(
            type='SingleStageDetector',
            backbone=dict(type='DarknetCSP', scale='v5s5p',
                          out_indices=[2, 3, 4]),
            neck=dict(type='YOLOV5Neck', in_channels=[128, 256, 512],
                      out_channels=[128, 64, 64], csp_repetition=1),
            bbox_head=dict(type='YOLOCSPHead', num_classes=NUM_CLASSES,
                           in_channels=[128, 64, 64]))
    return dict(
        type='SingleStageDetector',
        backbone=dict(type='DarknetCSP', scale='v4s5p', out_indices=[3, 4, 5]),
        neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
                  out_channels=[64, 64, 64], csp_repetition=1),
        bbox_head=dict(type='YOLOCSPHead', num_classes=NUM_CLASSES,
                       in_channels=[64, 64, 64]))


def tiny_batch(seed, batch_size=BATCH, size=IMG, g_max=3):
    """Random images and 1..g_max gts per image, padded to g_max."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((batch_size, g_max, 4), np.float32)
    valid = np.zeros((batch_size, g_max), bool)
    for i in range(batch_size):
        n = rng.randint(1, g_max + 1)
        xy = rng.rand(n, 2) * size * 0.5
        wh = rng.rand(n, 2) * size * 0.4 + 6
        gt[i, :n] = np.concatenate([xy, np.minimum(xy + wh, size)], -1)
        valid[i, :n] = True
    return {
        'img': rng.uniform(-0.45, 0.55, (batch_size, size, size, 3)).astype(
            np.float32),
        'gt_bboxes': gt,
        'gt_labels': rng.randint(0, NUM_CLASSES,
                                 (batch_size, g_max)).astype(np.int32),
        'gt_valid': valid,
    }


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def assert_tree_close(got, ref, init, what):
    """max |got - ref| <= 5e-3 * max |ref - init| (or 1e-6)."""
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(_leaves(got), _leaves(ref)))
    upd = max(float(np.abs(a - b).max())
              for a, b in zip(_leaves(ref), _leaves(init)))
    assert diff <= max(5e-3 * upd, 1e-6), (
        f'{what}: port vs tpudet {diff:.3e}, update {upd:.3e}')


@pytest.fixture(scope='module', params=['v4s', 'v5s'])
def runs(request):
    jmodel = jax_build_detector(tiny_cfg(request.param))
    jopt = JaxSGDConfig(**OPT)
    state0 = jax.device_get(jax_create_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jopt))
    scale = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda p, v: np.full_like(v, BN_SCALE) if p[-1].key == 'scale'
        else v, tree)
    state0 = state0.replace(params=scale(state0.params),
                            ema_params=scale(state0.ema_params))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, accumulation=ACCUM,
                                        **EMA))
    model = build_detector(tiny_cfg(request.param))
    opt = YoloSGDConfig(**OPT)
    state = train_state_from_flax(state0, model, opt)
    step = make_train_step(model, opt, accumulation=ACCUM, **EMA)

    jstate, jm, tm = state0, [], []
    for s in range(STEPS):
        batch = tiny_batch(seed=s)
        jstate, m = jstep(jstate, batch)
        jm.append({k: float(v) for k, v in m.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        tm.append({k: float(v) for k, v in m.items()})
    return state0, jax.device_get(jstate), jm, train_state_to_flax(
        state, model), tm


def test_losses_and_grad_norm_match_at_every_step(runs):
    _, _, jm, _, tm = runs
    for s in range(STEPS):
        for k in ('loss', 'loss_cls', 'loss_conf', 'loss_bbox', 'grad_norm',
                  'lr', 'momentum', 'num_gts'):
            np.testing.assert_allclose(tm[s][k], jm[s][k], rtol=1e-4,
                                       err_msg=f'step {s} {k}')
    # the clip is active, and tpudet's metric is the norm before it
    assert jm[0]['grad_norm'] > OPT['grad_clip_norm']
    assert np.isfinite(jm[1]['loss'])


@pytest.mark.parametrize('what', ['params', 'batch_stats', 'ema_params',
                                  'ema_batch_stats', 'momentum_buf'])
def test_state_matches_within_the_update(runs, what):
    state0, jstate, _, tstate, _ = runs
    if what == 'momentum_buf':
        got, ref, init = (tstate.opt_state.momentum_buf,
                          jstate.opt_state.momentum_buf,
                          state0.opt_state.momentum_buf)
    else:
        got, ref, init = (getattr(tstate, what), getattr(jstate, what),
                          getattr(state0, what))
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    assert_tree_close(got, ref, init, what)
    assert int(tstate.step) == int(jstate.step) == STEPS


def test_ema_blends_at_the_second_step(runs):
    """At step 0 the EMA momentum is 0, so the EMA equals the params; the
    second step blends, and the port's EMA leaves the params as tpudet's
    does."""
    _, jstate, _, tstate, _ = runs
    gap = lambda s: max(float(np.abs(a - b).max()) for a, b in zip(  # noqa
        _leaves(s.ema_params), _leaves(s.params)))
    assert gap(jstate) > 0
    np.testing.assert_allclose(gap(tstate), gap(jstate), rtol=0.05)


def _flagship_cfg():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return Config.fromfile(
        os.path.join(root, 'configs/yolov4/yolov4s_coco_mosaic.py'))


def test_init_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_trainer(_flagship_cfg(), max_steps=3)


def test_init_trainer_reads_the_config_and_steps_on_the_cpu():
    """The shipped YOLOv4 config, narrowed to the tiny model: accumulation
    from nominal_batch_size, the warm-up and EMA hooks, bf16 compute with
    fp32 master weights, and one finite step."""
    cfg = _flagship_cfg()
    cfg['model'] = dict(cfg['model'], **{k: v for k, v in tiny_cfg().items()
                                         if k != 'type'})
    cfg['data'] = dict(cfg['data'], samples_per_gpu=2)
    cfg['nominal_batch_size'] = 4
    cfg['compute_dtype'] = 'bfloat16'
    trainer = init_trainer(cfg, device='cpu', max_steps=2)
    assert trainer.accumulation == 2
    assert trainer.opt_cfg.warmup_iters == 10000 // 2
    assert trainer.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    before = {k: v.clone() for k, v in trainer.state.params.items()}
    m = trainer.step(tiny_batch(seed=5))
    assert np.isfinite(float(m['loss'])) and float(m['grad_norm']) > 0
    assert m['loss'].dtype == torch.float32
    assert any(not torch.equal(before[k], v)
               for k, v in trainer.state.params.items())
    assert int(trainer.state.step) == 1
