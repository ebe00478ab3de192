"""Optimizer, schedules and EMA: tpudet_torch against tpudet on the CPU, in
fp32, on a tiny YOLOv4 whose params, gradients and momentum buffers are
drawn from a numpy seed and carried across by ``flax_import``.

Tolerances: schedules rtol 1e-6 (both compute in fp32 with the same op
order); the global gradient norm rtol 1e-5 (a sum of 1.8 M fp32 squares,
taken in another order), and so the SGD and Adam updates, through the clip
scale, within 1e-5 of each tensor's largest value; the EMA fold rtol 1e-6 with atol 1e-7
(the same per-element ops).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.train import ema as JE
from tpudet.train import optim as JO
from tpudet_torch.models.builder import build_detector
from tpudet_torch.train import ema as TE
from tpudet_torch.train import optim as TO
from tpudet_torch.utils.flax_import import (leaf_table, random_flax_variables,
                                            state_dict_to_flax,
                                            train_state_from_flax,
                                            train_state_to_flax)

SCHED = dict(lr=0.01, total_steps=100, warmup_iters=10, min_lr_ratio=0.2)
STEPS = [0, 3, 9, 10, 11, 50, 99, 100, 150]


def tiny_model():
    return build_detector(dict(
        type='SingleStageDetector',
        backbone=dict(type='DarknetCSP', scale='v4s5p', out_indices=[3, 4, 5]),
        neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
                  out_channels=[32, 32, 32], csp_repetition=1),
        bbox_head=dict(type='YOLOCSPHead', num_classes=3,
                       in_channels=[32, 32, 32])))


def _randomized(tree, rng, scale=1.0):
    return jax.tree.map(
        lambda v: (rng.randn(*np.shape(v)) * scale).astype(np.float32), tree)


@pytest.mark.parametrize('cfg', [
    dict(), dict(steps_per_epoch=7), dict(policy='step', decay_steps=(20, 60)),
    dict(policy='fixed'), dict(warmup_iters=0)],
    ids=['cosine', 'cosine-epochs', 'step', 'fixed', 'no-warmup'])
def test_schedules_match(cfg):
    jc, tc = JO.YoloSGDConfig(**{**SCHED, **cfg}), TO.YoloSGDConfig(
        **{**SCHED, **cfg})
    for s in STEPS:
        js, ts = jnp.asarray(s, jnp.int32), torch.tensor(s)
        np.testing.assert_allclose(float(TO.schedule_lr(ts, tc)),
                                   float(JO.schedule_lr(js, jc)), rtol=1e-6)
        for got, ref in zip(TO.warmup_factors(ts, tc),
                            JO.warmup_factors(js, jc)):
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_group_labels_follow_the_flax_leaf_names():
    model = tiny_model()
    labels = TO.param_labels(model)
    assert labels['backbone.conv0.conv.weight'] == 'weight'
    assert labels['backbone.conv0.bn.weight'] == 'weight_nodecay'
    assert labels['backbone.conv0.bn.bias'] == 'bias'
    assert labels['bbox_head.conv_pred0.bias'] == 'bias'
    tree = state_dict_to_flax(model)['params']
    ref = {'/'.join(str(k.key) for k in path): JO.param_group_label(path, v)
           for path, v in jax.tree_util.tree_leaves_with_path(tree)}
    table = leaf_table(model)
    got = {'/'.join(p[1:]): labels[key] for p, (key, _) in table.items()
           if p[0] == 'params'}
    assert got == ref


def _flax_state(model, seed, adam=False):
    """A tpudet-shaped state with random params, stats and buffers."""
    rng = np.random.RandomState(seed)
    variables = random_flax_variables(model, seed=seed)
    params = _randomized(variables['params'], rng, 0.1)
    buf = _randomized(params, rng, 0.01)
    if adam:
        buf = jax.tree.map(lambda b: np.stack([b, np.abs(b)]), buf)
    return SimpleNamespace(
        step=np.int32(0), params=params,
        batch_stats=variables['batch_stats'], ema_params=params,
        ema_batch_stats=variables['batch_stats'],
        opt_state=SimpleNamespace(momentum_buf=buf)), _randomized(
            params, rng, 0.05)


NESTEROV, SGD, ADAM = dict(), dict(nesterov=False), dict(
    opt_type='adam', weight_decay=1e-3)


@pytest.mark.parametrize('opt,step', [
    (NESTEROV, 2), (NESTEROV, 10), (NESTEROV, 40), (SGD, 40), (ADAM, 2)],
    ids=['nesterov-2', 'nesterov-10', 'nesterov-40', 'sgd-40', 'adam-2'])
def test_update_matches(opt, step):
    """One update inside warm-up (2), at its end (10) and after it (40);
    the clip is active (norm 35 against gradients of norm ~ 70)."""
    model = tiny_model()
    jc = JO.YoloSGDConfig(**{**SCHED, **opt})
    tc = TO.YoloSGDConfig(**{**SCHED, **opt})
    fstate, grads = _flax_state(model, seed=step, adam='adam' in str(opt))
    state = train_state_from_flax(fstate, model, tc)
    tgrads = {}
    for path, (key, is_kernel) in leaf_table(model).items():
        if path[0] == 'params':
            node = grads
            for p in path[1:]:
                node = node[p]
            g = np.transpose(node, (3, 2, 0, 1)) if is_kernel else node
            tgrads[key] = torch.from_numpy(np.ascontiguousarray(g))

    jupdate = jax.jit(JO.make_yolo_sgd(jc)[1])
    jparams, jopt, jm = jupdate(
        jax.tree.map(jnp.asarray, grads),
        JO.SGDState(jax.tree.map(jnp.asarray, fstate.opt_state.momentum_buf)),
        jax.tree.map(jnp.asarray, fstate.params), jnp.asarray(step))
    _, update = TO.make_yolo_sgd(tc, TO.param_labels(model))
    _, _, tm = update(tgrads, state.opt_state, state.params,
                      torch.tensor(step))
    assert float(jm['grad_norm']) > tc.grad_clip_norm
    np.testing.assert_allclose(float(tm['grad_norm']),
                               float(jm['grad_norm']), rtol=1e-5)
    for k in ('lr', 'momentum'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    back = train_state_to_flax(state, model)
    for got, ref in ((back.params, jparams),
                     (back.opt_state.momentum_buf, jopt.momentum_buf)):
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            r = np.asarray(r)
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize('step', [0, 1, 7, 5000])
def test_ema_momentum_matches(step):
    np.testing.assert_allclose(
        float(TE.ema_momentum(torch.tensor(step), 0.9999, 2000, 3)),
        float(JE.ema_momentum(jnp.asarray(step, jnp.int32), 0.9999, 2000, 3)),
        rtol=1e-6)


def test_ema_update_blends_floats_and_copies_counters():
    rng = np.random.RandomState(0)
    ema = {'a': rng.randn(5, 3).astype(np.float32),
           'b': rng.randn(7).astype(np.float32)}
    online = {k: rng.randn(*v.shape).astype(np.float32)
              for k, v in ema.items()}
    m = 0.37
    ref = JE.ema_update(ema, online, jnp.float32(m))
    t_ema = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    t_ema['n'] = torch.tensor(3)
    t_online = {k: torch.from_numpy(v) for k, v in online.items()}
    t_online['n'] = torch.tensor(11)
    out = TE.ema_update(t_ema, t_online, torch.tensor(m))
    assert out is t_ema and int(out['n']) == 11
    for k in ema:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)
    assert TE.ema_interval(64, 12) == JE.ema_interval(64, 12) == 6
    assert TE.ema_interval(None, 12) == 1
