"""``flax_import`` carries every leaf of tpudet's flagship tree.

The tree's structure comes from tpudet itself (``jax.eval_shape`` of the
YOLOv4-l flagship's ``init``, no weights computed); values are numpy draws.
Every leaf must land in the port's flagship ``state_dict`` with its value
(kernels transposed HWIO -> OIHW), every tensor of the port must be
reached, and nothing may be left over. Exact: values are copied.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.config import Config as JaxConfig
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet_torch.config import Config
from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import (flax_to_state_dict, leaf_table,
                                            load_flax_variables,
                                            random_flax_variables)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'configs/yolov4/yolov4l_coco_mosaic.py')


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.fixture(scope='module')
def flagship():
    jmodel = jax_build_detector(JaxConfig.fromfile(CONFIG)['model'])
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.bfloat16))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    tree = jax.tree_util.tree_map(np.asarray, dict(tree))
    model = build_detector(Config.fromfile(CONFIG)['model'])
    return _flatten(tree), tree, model


def test_every_leaf_lands_with_its_value(flagship):
    leaves, tree, model = flagship
    sd = flax_to_state_dict(tree, model)
    table = leaf_table(model)
    assert set(leaves) == set(table)  # no leftovers either way
    assert len(leaves) == 115 + 108 * 4 + 3  # convs, BN sites, head biases
    for path, value in leaves.items():
        key, is_kernel = table[path]
        got = sd[key].numpy()
        if is_kernel:
            got = np.transpose(got, (2, 3, 1, 0))
        np.testing.assert_array_equal(got, value)
    tracked = [k for k in sd if k.endswith('num_batches_tracked')]
    assert len(sd) == len(leaves) + len(tracked)


def test_round_trip_through_the_model(flagship):
    leaves, tree, model = flagship
    load_flax_variables(model, tree)
    sd = model.state_dict()
    for path, (key, is_kernel) in leaf_table(model).items():
        got = sd[key].numpy()
        if is_kernel:
            got = np.transpose(got, (2, 3, 1, 0))
        np.testing.assert_array_equal(got, leaves[path])


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def test_refuses_what_it_cannot_place(flagship):
    _, tree, model = flagship
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad['params']['backbone']['conv0']['extra'] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match='no place'):
        flax_to_state_dict(bad, model)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    _set(bad, ('params', 'backbone', 'conv0', 'conv', 'kernel'),
         np.zeros((3, 3, 3, 33), np.float32))
    with pytest.raises(ValueError, match='does not fit'):
        flax_to_state_dict(bad, model)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad['batch_stats']['neck']['out_conv2']['bn']['var']
    with pytest.raises(KeyError, match='not in the flax variables'):
        flax_to_state_dict(bad, model)


def test_random_variables_follow_tpudet_init(flagship):
    leaves, _, model = flagship
    tree = random_flax_variables(model, seed=0)
    flat = _flatten(tree)
    assert {p: v.shape for p, v in flat.items()} == {
        p: v.shape for p, v in leaves.items()}
    k = flat[('params', 'backbone', 'bottleneck1_down', 'conv', 'kernel')]
    std = np.sqrt(2.0 / (3 * 3 * 32))
    assert abs(k.std() / std - 1) < 0.05 and np.abs(k).max() <= 2.3 * std
    head = model.bbox_head
    np.testing.assert_array_equal(
        flat[('params', 'bbox_head', 'conv_pred1', 'bias')],
        head.bias_prior(1))
    assert (flat[('batch_stats', 'neck', 'td_csp0', 'csp_bn', 'bn', 'var')]
            == 1).all()
    again = random_flax_variables(model, seed=0)
    np.testing.assert_array_equal(
        _flatten(again)[('params', 'neck', 'out_conv0', 'conv', 'kernel')],
        flat[('params', 'neck', 'out_conv0', 'conv', 'kernel')])
    assert torch.is_tensor(flax_to_state_dict(tree, model)['bbox_head.'
                                                           'conv_pred0.bias'])


def test_random_variables_of_a_grouped_conv():
    """A grouped conv's kernel is (kh, kw, cin / groups, cout) in both
    packages, and tpudet's he_normal draws it with fan-in
    kh * kw * cin / groups."""
    from tpudet.models.layers import ConvModule as JaxConvModule
    from tpudet_torch.models.layers import ConvModule
    jmod = JaxConvModule(features=64, kernel_size=3, groups=4)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 128)))
    tmod = ConvModule(128, 64, 3, groups=4)
    flat = _flatten(random_flax_variables(tmod, seed=1))
    assert {p: v.shape for p, v in flat.items()} == {
        p: tuple(s.shape) for p, s in _flatten(dict(shapes)).items()}
    k = flat[('params', 'conv', 'kernel')]
    assert k.shape == (3, 3, 32, 64)
    std = np.sqrt(2.0 / (3 * 3 * 32))
    assert abs(k.std() / std - 1) < 0.05 and np.abs(k).max() <= 2.3 * std
