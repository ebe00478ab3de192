"""Checkpoint I/O: counterpart of ``tpudet/utils/checkpoint.py``.

Weights (``save_variables`` / ``load_variables``) are tpudet's ``*.msgpack``
payload, byte for byte: ``{'meta': json str, 'arrays': {'a/b/c': {'dtype',
'shape', 'data'}}}``. The card's machine has no ``msgpack`` package, so
the port packs and unpacks the subset of the format that the payload uses
(maps, arrays, str, bin, ints), as ``msgpack.packb`` / ``unpackb`` do with
their defaults (``use_bin_type``, the smallest encoding of each value).

The train state (``save_train_state`` / ``load_train_state`` /
``latest_step``) is the port's own format: the same payload, holding the
tpudet-layout trees of ``flax_import.train_state_to_flax`` (params, BN
statistics, EMA copies, optimizer buffers) and the step in the meta, in
``<ckpt_dir>/<step>/train_state.msgpack``. tpudet keeps its train state in
orbax directories, which the port does not read (ROADMAP.md).
"""
from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import struct
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

STATE_FILE = 'train_state.msgpack'


def _pack(obj, out: List[bytes]):
    if isinstance(obj, int) and not isinstance(obj, bool):
        out.append(_pack_int(obj))
    elif isinstance(obj, str):
        data = obj.encode('utf-8')
        n = len(data)
        if n < 32:
            out.append(bytes([0xa0 | n]))
        else:
            out.append(_sized(n, b'\xd9', b'\xda', b'\xdb'))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_sized(len(data), b'\xc4', b'\xc5', b'\xc6'))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(bytes([0x90 | n]) if n < 16 else
                   _sized(n, None, b'\xdc', b'\xdd'))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        out.append(bytes([0x80 | n]) if n < 16 else
                   _sized(n, None, b'\xde', b'\xdf'))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f'cannot pack {type(obj).__name__}')


def _sized(n: int, tag8, tag16, tag32) -> bytes:
    """The header of a str, bin, array or map of length ``n``."""
    if tag8 is not None and n < 1 << 8:
        return tag8 + struct.pack('>B', n)
    if n < 1 << 16:
        return tag16 + struct.pack('>H', n)
    if n < 1 << 32:
        return tag32 + struct.pack('>I', n)
    raise ValueError(f'length {n} does not fit msgpack')


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -0x20 <= v < 0:
        return struct.pack('>b', v)
    for lo, hi, tag, fmt in ((0, 0xff, 0xcc, '>B'), (-0x80, 0x7f, 0xd0, '>b'),
                             (0, 0xffff, 0xcd, '>H'),
                             (-0x8000, 0x7fff, 0xd1, '>h'),
                             (0, 0xffffffff, 0xce, '>I'),
                             (-0x80000000, 0x7fffffff, 0xd2, '>i'),
                             (0, 0xffffffffffffffff, 0xcf, '>Q'),
                             (-0x8000000000000000, 0x7fffffffffffffff, 0xd3,
                              '>q')):
        if lo <= v <= hi and (v >= 0) == (lo == 0):
            return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f'{v} does not fit msgpack')


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for the subset above."""
    out: List[bytes] = []
    _pack(obj, out)
    return b''.join(out)


# the ints after a tag: (struct format, size)
_FIXED = {0xcc: ('>B', 1), 0xcd: ('>H', 2), 0xce: ('>I', 4), 0xcf: ('>Q', 8),
          0xd0: ('>b', 1), 0xd1: ('>h', 2), 0xd2: ('>i', 4), 0xd3: ('>q', 8)}


class _Reader:

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def uint(self, size: int) -> int:
        return int.from_bytes(self.take(size), 'big')

    def read(self):
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.map(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return [self.read() for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return str(self.take(tag & 0x1f), 'utf-8')
        if tag in _FIXED:
            fmt, size = _FIXED[tag]
            return struct.unpack(fmt, self.take(size))[0]
        if tag in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.uint(1 << (tag - 0xc4))))
        if tag in (0xd9, 0xda, 0xdb):
            return str(self.take(self.uint(1 << (tag - 0xd9))), 'utf-8')
        if tag in (0xdc, 0xdd):
            return [self.read() for _ in range(self.uint(2 << (tag - 0xdc)))]
        if tag in (0xde, 0xdf):
            return self.map(self.uint(2 << (tag - 0xde)))
        raise ValueError(f'msgpack type 0x{tag:02x} is not supported')

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for the subset above."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(data):
        raise ValueError('extra bytes after the msgpack object')
    return obj


def _tree_to_flat(tree, prefix=()) -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tree_to_flat(v, prefix + (k,)))
    else:
        out['/'.join(prefix)] = np.asarray(tree)
    return out


def _flat_to_tree(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split('/')
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def variables_payload(variables: Dict, meta: Optional[Dict] = None) -> Dict:
    """tpudet's checkpoint payload of a nested dict of arrays."""
    return {
        'meta': json.dumps(meta or {}),
        'arrays': {
            k: {
                'dtype': str(v.dtype),
                'shape': list(v.shape),
                'data': v.tobytes()
            }
            for k, v in _tree_to_flat(variables).items()
        },
    }


def save_variables(path: str, variables: Dict, meta: Optional[Dict] = None):
    """Save a nested dict of numpy arrays (tpudet's ``{'params',
    'batch_stats'}`` layout) and a JSON-able ``meta`` as tpudet does."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        f.write(packb(variables_payload(variables, meta)))


def load_variables(path: str) -> Tuple[Dict, Dict]:
    """(tree of numpy arrays, meta) of a file that tpudet's or the port's
    ``save_variables`` wrote."""
    with open(path, 'rb') as f:
        payload = unpackb(f.read())
    meta = json.loads(payload['meta'])
    flat = {
        k: np.frombuffer(rec['data'],
                         dtype=np.dtype(rec['dtype'])).reshape(rec['shape'])
        for k, rec in payload['arrays'].items()
    }
    return _flat_to_tree(flat), meta


def save_train_state(ckpt_dir: str, state, model, step: int):
    """Write the port's ``TrainState`` of ``model`` as
    ``<ckpt_dir>/<step>/train_state.msgpack``; the directory appears
    whole or not at all (written beside it, then renamed)."""
    from .flax_import import train_state_to_flax
    flax = train_state_to_flax(state, model)
    trees = dict(params=flax.params, batch_stats=flax.batch_stats,
                 ema_params=flax.ema_params,
                 ema_batch_stats=flax.ema_batch_stats,
                 opt_state=dict(momentum_buf=flax.opt_state.momentum_buf))
    final = osp.join(ckpt_dir, str(int(step)))
    tmp = final + '.tmp'
    shutil.rmtree(tmp, ignore_errors=True)
    save_variables(osp.join(tmp, STATE_FILE), trees,
                   meta=dict(step=int(step)))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step saved in ``ckpt_dir``, or None."""
    if not osp.isdir(ckpt_dir):
        return None
    steps = [int(n) for n in os.listdir(ckpt_dir)
             if n.isdigit() and osp.isfile(osp.join(ckpt_dir, n,
                                                    STATE_FILE))]
    return max(steps) if steps else None


def load_train_state(ckpt_dir: str, model, opt_cfg,
                     step: Optional[int] = None):
    """The port's ``TrainState`` saved at ``step`` (the latest without
    it): params and BN statistics are loaded into ``model``, the EMA
    copies and optimizer buffers are new tensors on its device
    (``flax_import.train_state_from_flax``)."""
    from .flax_import import train_state_from_flax
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f'no train state in {ckpt_dir}')
    trees, meta = load_variables(osp.join(ckpt_dir, str(step), STATE_FILE))
    flax = SimpleNamespace(
        step=np.asarray(meta['step'], np.int32), params=trees['params'],
        batch_stats=trees['batch_stats'], ema_params=trees['ema_params'],
        ema_batch_stats=trees['ema_batch_stats'],
        opt_state=SimpleNamespace(
            momentum_buf=trees['opt_state']['momentum_buf']))
    return train_state_from_flax(flax, model, opt_cfg)
