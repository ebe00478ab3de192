"""The port's checkpoints (``tpudet_torch/utils/checkpoint.py``) against
tpudet's and the ``msgpack`` package, on the CPU.

The port packs tpudet's weight payload with its own msgpack subset: its
bytes must equal ``msgpack.packb`` of the same payload, tpudet's
``load_variables`` must read the port's file and the port tpudet's. The
port's train state (its own format) must come back unchanged. Tolerance:
exact.
"""
import json
import os

import msgpack
import numpy as np
import pytest
import torch

from tpudet.utils import checkpoint as J
from tpudet_torch.models.builder import build_detector
from tpudet_torch.train.optim import YoloSGDConfig
from tpudet_torch.train.train_state import create_train_state, make_train_step
from tpudet_torch.utils import checkpoint as P
from tpudet_torch.utils.flax_import import (load_flax_variables,
                                            random_flax_variables,
                                            train_state_to_flax)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
        -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {'params': {'backbone': {'conv0': {
        'kernel': rng.randn(3, 3, 3, 8).astype(np.float32),
        'bias': rng.randn(8).astype(np.float32)}},
        'head': {'w': rng.randn(40, 50).astype(np.float32)}},
        'batch_stats': {'bn': {'mean': rng.randn(8).astype(np.float32),
                               'var': np.ones(8, np.float32)}},
        'step': np.asarray(7, np.int32), 'half': np.ones(3, np.float16)}


@pytest.mark.parametrize('obj', [
    INTS, ['', 'a' * 31, 'a' * 32, 'a' * 255, 'a' * 256, 'a' * 65536, 'ünï'],
    [b'', b'x' * 255, b'x' * 256, b'x' * 70000],
    [list(range(15)), list(range(16)), list(range(70000))],
    {str(i): i for i in range(16)}, {str(i): [] for i in range(70000)},
    [{}, [[]], {'a': {'b': {'c': b'd'}}}],
], ids=['ints', 'str', 'bin', 'arrays', 'map16', 'map32', 'nested'])
def test_packb_equals_msgpack(obj):
    data = P.packb(obj)
    assert data == msgpack.packb(obj)
    assert P.unpackb(data) == msgpack.unpackb(data)


@pytest.mark.parametrize('obj', [1.5, None, True, np.float32(1)],
                         ids=['float', 'nil', 'bool', 'numpy'])
def test_packb_refuses_what_the_payload_does_not_use(obj):
    with pytest.raises(TypeError):
        P.packb([obj])
    if not isinstance(obj, np.floating):
        with pytest.raises(ValueError, match='not supported'):
            P.unpackb(msgpack.packb(obj))


@pytest.mark.parametrize('seed', [0, 1])
def test_variables_payload_bytes_equal_msgpack(seed):
    meta = dict(step=3, CLASSES=['a', 'b'], map=0.25)
    payload = P.variables_payload(_tree(seed), meta)
    assert P.packb(payload) == msgpack.packb(payload)


def test_tpudet_reads_the_port_file_and_back(tmp_path):
    tree, meta = _tree(2), dict(step=5, CLASSES=['x'])
    P.save_variables(str(tmp_path / 'port.msgpack'), tree, meta)
    J.save_variables(str(tmp_path / 'ref.msgpack'), tree, meta)
    assert (tmp_path / 'port.msgpack').read_bytes() == \
        (tmp_path / 'ref.msgpack').read_bytes()
    for reader in (J.load_variables, P.load_variables):
        for name in ('port.msgpack', 'ref.msgpack'):
            got, got_meta = reader(str(tmp_path / name))
            assert got_meta == meta
            flat_got, flat_ref = P._tree_to_flat(got), P._tree_to_flat(tree)
            assert list(flat_got) == list(flat_ref)
            for k, v in flat_ref.items():
                assert flat_got[k].dtype == v.dtype
                np.testing.assert_array_equal(flat_got[k], v)


def test_unpackb_refuses_truncated_and_trailing_bytes():
    data = P.packb({'a': b'xyz'})
    with pytest.raises(ValueError, match='truncated'):
        P.unpackb(data[:-1])
    with pytest.raises(ValueError, match='extra'):
        P.unpackb(data + b'\x00')


def _tiny():
    return build_detector(dict(
        type='SingleStageDetector',
        backbone=dict(type='DarknetCSP', scale='v4s5p', out_indices=[3, 4, 5]),
        neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
                  out_channels=[32, 32, 32], csp_repetition=1),
        bbox_head=dict(type='YOLOCSPHead', num_classes=3,
                       in_channels=[32, 32, 32])))


def _trained_state():
    """A state after one step, so EMA, momentum and BN statistics differ
    from the params and from their init."""
    model = _tiny()
    load_flax_variables(model, random_flax_variables(model, seed=0))
    opt = YoloSGDConfig(lr=0.01, total_steps=10, warmup_iters=2)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, ema_warm_up=2)
    rng = np.random.RandomState(0)
    batch = dict(img=torch.from_numpy(rng.uniform(-.5, .5, (2, 64, 64, 3))
                                      .astype(np.float32)),
                 gt_bboxes=torch.tensor([[[4., 4., 30., 40.]]] * 2),
                 gt_labels=torch.zeros((2, 1), dtype=torch.int64),
                 gt_valid=torch.ones((2, 1), dtype=torch.bool))
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    return model, opt, state


def _leaves(ns):
    return {'params': ns.params, 'batch_stats': ns.batch_stats,
            'ema_params': ns.ema_params,
            'ema_batch_stats': ns.ema_batch_stats,
            'momentum_buf': ns.opt_state.momentum_buf}


def test_train_state_survives_save_and_load(tmp_path):
    model, opt, state = _trained_state()
    before = train_state_to_flax(state, model)
    P.save_train_state(str(tmp_path / 'ckpts'), state, model, 2)
    assert P.latest_step(str(tmp_path / 'ckpts')) == 2
    fresh = _tiny()
    load_flax_variables(fresh, random_flax_variables(fresh, seed=1))
    loaded = P.load_train_state(str(tmp_path / 'ckpts'), fresh, opt)
    after = train_state_to_flax(loaded, fresh)
    assert int(after.step) == int(before.step) == 2
    got, ref = (P._tree_to_flat(_leaves(after)),
                P._tree_to_flat(_leaves(before)))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the params are the fresh model's own tensors
    assert all(loaded.params[k] is p for k, p in fresh.named_parameters())


def test_latest_step_skips_unfinished_saves(tmp_path):
    d = tmp_path / 'ckpts'
    assert P.latest_step(str(d)) is None
    model, _, state = _trained_state()
    P.save_train_state(str(d), state, model, 4)
    P.save_train_state(str(d), state, model, 12)
    os.makedirs(d / '20.tmp')  # a save that did not finish
    os.makedirs(d / '30')  # a directory without a state file
    assert P.latest_step(str(d)) == 12
    meta = json.loads(P.unpackb((d / '12' / P.STATE_FILE).read_bytes())[
        'meta'])
    assert meta == {'step': 12}


def test_the_port_imports_neither_msgpack_nor_orbax():
    """The card's machine has neither package: the port packs msgpack
    itself."""
    import ast
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, 'chip_smoke.py')]
    for d, _, names in os.walk(os.path.join(root, 'tpudet_torch')):
        files += [os.path.join(d, n) for n in names if n.endswith('.py')]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names
                   if n.split('.')[0] in ('msgpack', 'orbax')]
            assert not bad, f'{path}:{node.lineno} imports {bad}'
