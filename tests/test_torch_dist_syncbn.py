"""The port's process groups (``tpudet_torch/parallel/mesh.py``) and
SyncBN on the CPU: two gloo ranks, one OS process each
(``tests/torch_fixtures/dist.py``).

SyncBN: the port's ``BatchNorm2d`` in training on each rank's half of a
batch against flax's ``nn.BatchNorm`` (tpudet's, ``tpudet/models/
layers.py:95-100``) on the whole batch: outputs, the biased running
statistics, and the gradients of x, the scale and the bias (each rank's
scale and bias gradient summed, as the step's gradient all-reduce sums
them), fp32, within 2e-5 relative (and 2e-6 absolute): the two sides
reduce in other orders, and the port merges per-rank statistics with
Chan's formula where flax takes ``E[x^2] - E[x]^2``.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet_torch.parallel import (all_reduce_grads, broadcast_,
                                   global_count, global_sum,
                                   init_distributed, is_distributed,
                                   process_count, process_index)
from tpudet_torch.parallel.mesh import shared_devices

from .torch_fixtures.dist import run_ranks, syncbn_job
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

RTOL, ATOL = 2e-5, 2e-6
EPS, MOMENTUM = 1e-3, 0.03  # tpudet's CSP BatchNorm: flax momentum 0.97


def flax_batch_norm(x, dy, scale, bias):
    """flax's ``nn.BatchNorm`` in training on the whole NCHW batch: the
    output, the new running statistics from (0, 1) and the gradients."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=1 - MOMENTUM,
                       epsilon=EPS)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = {'params': {'scale': jnp.asarray(scale),
                            'bias': jnp.asarray(bias)},
                 'batch_stats': {'mean': jnp.zeros(x.shape[1]),
                                 'var': jnp.ones(x.shape[1])}}

    def f(params, xh):
        y, upd = bn.apply({'params': params,
                           'batch_stats': variables['batch_stats']}, xh,
                          mutable=['batch_stats'])
        return (y * jnp.asarray(dy.transpose(0, 2, 3, 1))).sum(), (y, upd)

    (_, (y, upd)), (g_params, g_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables['params'], xh)
    t = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return dict(y=t(y), dx=t(g_x), dscale=np.asarray(g_params['scale']),
                dbias=np.asarray(g_params['bias']),
                mean=np.asarray(upd['batch_stats']['mean']),
                var=np.asarray(upd['batch_stats']['var']))


@pytest.fixture(scope='module')
def bn_inputs():
    rng = np.random.RandomState(0)
    # an offset mean and unequal halves, so that the per-rank statistics
    # differ and Chan's merge has work to do
    x = (rng.randn(4, 6, 5, 7) * 2.5 + 3.0).astype(np.float32)
    x[2:] = x[2:] * 0.5 - 1.0
    dy = rng.randn(4, 6, 5, 7).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.uniform(-1, 1, 6).astype(np.float32)
    return x, dy, scale, bias


def test_syncbn_on_two_ranks_matches_flax_on_the_whole_batch(bn_inputs,
                                                             tmp_path):
    x, dy, scale, bias = bn_inputs
    ref = flax_batch_norm(x, dy, scale, bias)
    ranks = run_ranks(syncbn_job, 2, tmp_path, x, dy, scale, bias, EPS,
                      MOMENTUM)
    got = dict(y=np.concatenate([r['y'] for r in ranks]),
               dx=np.concatenate([r['dx'] for r in ranks]),
               dscale=ranks[0]['dscale'] + ranks[1]['dscale'],
               dbias=ranks[0]['dbias'] + ranks[1]['dbias'],
               mean=ranks[0]['mean'], var=ranks[0]['var'])
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the running statistics are the same on both ranks
    for k in ('mean', 'var'):
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k])
    # one rank's half alone has other statistics: the sync is real
    alone = flax_batch_norm(x[:2], dy[:2], scale, bias)
    assert np.abs(alone['var'] - ref['var']).max() > 1e-2
    # the running variance moves by the biased global variance (torch's
    # nn.SyncBatchNorm would move it by the unbiased one, n / (n - 1)
    # times larger)
    biased = x.transpose(1, 0, 2, 3).reshape(6, -1).var(1)
    np.testing.assert_allclose(got['var'], (1 - MOMENTUM) + MOMENTUM * biased,
                               rtol=1e-5)


def test_nccl_with_two_ranks_on_one_device_raises(tmp_path):
    with pytest.raises(AssertionError, match="ask for the 'gloo' backend"):
        run_ranks(syncbn_job, 2, tmp_path, *([None] * 6), backend='nccl')


def test_shared_devices_groups_the_ranks_of_one_device():
    assert shared_devices(['a/cuda:0', 'a/cuda:1', 'b/cuda:0']) == []
    assert shared_devices(['a/cuda:0', 'a/cuda:0', 'a/cuda:1',
                           'a/cuda:1', 'b/cuda:1']) == [[0, 1], [2, 3]]


def test_without_a_group_everything_is_local(tmp_path):
    """One process (or none asked for) opens no group, and every
    collective is the identity: the model runs as on one device."""
    assert init_distributed(None, None, None, device='cpu') == \
        torch.device('cpu')
    assert init_distributed(f'file://{tmp_path}/r', 1, 0, device='cpu') == \
        torch.device('cpu')
    assert not is_distributed()
    assert (process_index(), process_count()) == (0, 1)
    t = torch.tensor([3.0])
    assert global_sum(t) is t
    assert float(global_count(5, 'cpu')) == 5.0
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 2.0)
    all_reduce_grads([p])
    broadcast_([p])
    assert p.grad.tolist() == [2.0, 2.0] and p.tolist() == [1.0, 1.0]


@pytest.mark.parametrize('flags, match', [
    (dict(num_processes=2), 'needs --coordinator'),
    (dict(num_processes=2, coordinator='localhost:1', process_id=2),
     r'not in \[0, 2\)')])
def test_an_incomplete_multi_process_request_is_refused(flags, match):
    with pytest.raises(ValueError, match=match):
        init_distributed(device='cpu', **flags)
