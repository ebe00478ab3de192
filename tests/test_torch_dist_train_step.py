"""Data-parallel training on the CPU: the port's train step on two gloo
ranks (one OS process each, ``tests/torch_fixtures/dist.py``) against
tpudet's ``make_train_step`` on the global batch, in fp32.

The model, inputs and tolerances are ``test_torch_train_step.py``'s:
YOLOv4 at the v4s scale with a narrow neck, 64 px, 4 classes, a warm-up of
3 steps, clipping at norm 10, EMA warm-up 4, every BatchNorm scale at
0.25; two steps. Each rank's loader batch holds 2 images a micro-batch,
so the global micro-batch is 4 images. Losses, ``num_gts`` and the
gradient norm to rtol 1e-4 at every step; params, BN statistics, EMA
copies and momentum buffers within 5e-3 of the largest change the two
steps made to them.

The grouping: the port's rank ``r`` takes micro-batch ``i`` from its own
``i``-th slice, and the global micro-batch ``i`` is those slices of both
ranks; tpudet is fed the global batch laid out so that its reshape to
(accumulation, -1) gives the same micro-batches. At accumulation 1 that
layout is tpudet's own row order (the ranks' batches one after the other).

The two ranks end with bit-equal states: every rank merges the same
all-reduced sums.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step

from .test_torch_train_step import (BN_SCALE, EMA, IMG, OPT,
                                    assert_tree_close, tiny_batch, tiny_cfg)
from .torch_fixtures.dist import Ranks, train_step_job
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, MICRO, STEPS = 2, 2, 2


def _numpy(tree):
    return {k: _numpy(v) if hasattr(v, 'items') else np.asarray(v)
            for k, v in tree.items()}


def global_layout(rank_batches, accumulation):
    """The global batch whose reshape to (accumulation, -1) gives, as
    micro-batch ``i``, every rank's ``i``-th slice in rank order."""
    return {k: np.concatenate([
        b[k][i * MICRO:(i + 1) * MICRO]
        for i in range(accumulation) for b in rank_batches])
        for k in rank_batches[0]}


@pytest.fixture(scope='module')
def start():
    """tpudet's model, its step-0 state (every BatchNorm scale at 0.25)
    and the same state as numpy trees for the ranks."""
    jmodel = jax_build_detector(tiny_cfg())
    state0 = jax.device_get(jax_create_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
        JaxSGDConfig(**OPT)))
    scale = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda p, v: np.full_like(v, BN_SCALE) if p[-1].key == 'scale'
        else v, tree)
    state0 = state0.replace(params=scale(state0.params),
                            ema_params=scale(state0.ema_params))
    flax_state = SimpleNamespace(
        step=np.asarray(state0.step), params=_numpy(state0.params),
        batch_stats=_numpy(state0.batch_stats),
        ema_params=_numpy(state0.ema_params),
        ema_batch_stats=_numpy(state0.ema_batch_stats),
        opt_state=SimpleNamespace(
            momentum_buf=_numpy(state0.opt_state.momentum_buf)))
    return jmodel, state0, flax_state


@pytest.fixture(scope='module', params=[1, 2], ids=['accum1', 'accum2'])
def runs(request, start, tmp_path_factory):
    accumulation = request.param
    jmodel, state0, flax_state = start
    # each step: the ranks' loader batches, one after the other
    local = MICRO * accumulation
    loader = [tiny_batch(seed=10 + s, batch_size=WORLD * local)
              for s in range(STEPS)]
    ranks = Ranks(train_step_job, WORLD,
                  tmp_path_factory.mktemp(f'accum{accumulation}'),
                  tiny_cfg(), flax_state, OPT, EMA, accumulation, loader)
    jstep = jax.jit(jax_make_train_step(jmodel, JaxSGDConfig(**OPT),
                                        accumulation=accumulation, **EMA))
    jstate, jm = state0, []
    for batch in loader:
        ranks_batches = [{k: v[r * local:(r + 1) * local]
                          for k, v in batch.items()} for r in range(WORLD)]
        glob = global_layout(ranks_batches, accumulation)
        if accumulation == 1:
            for k in batch:
                np.testing.assert_array_equal(glob[k], batch[k])
        jstate, m = jstep(jstate, glob)
        jm.append({k: float(v) for k, v in m.items()})
    return state0, jax.device_get(jstate), jm, ranks.join()


def test_losses_and_grad_norm_match_tpudets_global_step(runs):
    _, _, jm, ranks = runs
    for _, tm in ranks:
        for s in range(STEPS):
            for k in ('loss', 'loss_cls', 'loss_conf', 'loss_bbox',
                      'num_gts', 'grad_norm', 'lr', 'momentum'):
                np.testing.assert_allclose(tm[s][k], jm[s][k], rtol=1e-4,
                                           err_msg=f'step {s} {k}')


@pytest.mark.parametrize('what', ['params', 'batch_stats', 'ema_params',
                                  'ema_batch_stats', 'momentum_buf'])
def test_state_matches_tpudets_global_step(runs, what):
    state0, jstate, _, ranks = runs

    def pick(s):
        if what == 'momentum_buf':
            return s.opt_state.momentum_buf
        return getattr(s, what)
    for tstate, _ in ranks:
        assert_tree_close(pick(tstate), pick(jstate), pick(state0), what)
        assert int(tstate.step) == STEPS
    # both ranks hold the same state, bit for bit
    a, b = (jax.tree.leaves(pick(t)) for t, _ in ranks)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
