"""Carry tpudet weights across, both ways: a tpudet ``{'params',
'batch_stats'}`` tree of numpy arrays <-> the port's ``state_dict``, and a
tpudet ``TrainState`` <-> the port's (``train_state_from_flax``,
``train_state_to_flax``).

The port's modules carry the flax names, so a leaf's path is its module
path: ``params/backbone/conv0/conv/kernel`` is ``backbone.conv0.conv.weight``.

- a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW); a conv ``bias`` is
  carried as it is;
- a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), and its
  ``bias`` is carried as it is;
- a ConvTranspose ``kernel`` (H, W, in, out) becomes ``weight`` (in, out,
  H, W) with both spatial axes flipped: flax correlates the dilated input
  with the kernel as it is (``transpose_kernel=False``), torch's
  transposed conv with the kernel flipped. The writer back to flax flips
  them again. The layer's type tells the two kernels
  apart, not their rank: an Adam buffer stacks (m, v) on a leading axis,
  so a Dense kernel there is 3-D. The port flattens a pooled RoI in
  tpudet's HWC order (``Shared2FCBBoxHead``), so the rows of
  ``shared_fc0`` need no permutation;
- a deformable conv's ``kernel`` (K*K, in, out) becomes ``weight``
  (out, in, K, K), a conv's layout (``ops/deform_conv.py``; the
  ``DEFORM`` kind);
- BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) become
  ``weight/bias/running_mean/running_var``; GroupNorm's and flax
  LayerNorm's ``scale/bias`` (params only) become ``weight/bias``;
- a module's raw parameters (``GeneralizedAttention``'s ``gamma``,
  ``key_content_bias``, ``geom_bias``; ``L2Norm``'s ``scale``) are
  carried under the names its ``flax_leaves`` gives them.

Every leaf must find its tensor, with its shape, and every tensor of the
model must be reached: anything else raises. Nothing is dropped. The only
tensors tpudet has no leaf for are BatchNorm's ``num_batches_tracked``
counters: zero on the way in, left out on the way out. One exception: a
model's ``flax_optional`` names top-level subtrees that tpudet's ``init``
does not create (a KD detector's teacher, made only by ``forward_train``);
a tree with none of them loads with those modules left as they are (a
tree with some of them must hold all).
"""
from __future__ import annotations

from collections.abc import Mapping
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]


CONV, DENSE, DECONV, DEFORM = 'conv', 'dense', 'deconv', 'deform'


def leaf_table(model: nn.Module) -> Dict[Path, Tuple[str, str]]:
    """``(collection, *module path, leaf)`` -> ``(state_dict key, kernel
    kind)`` for every tensor of ``model`` that tpudet holds; the kind is
    ``CONV``, ``DENSE``, ``DECONV`` or ``DEFORM`` for a kernel and ``''``
    (false) for any other leaf. A module with a ``flax_leaves`` mapping
    (torch parameter name -> (flax leaf, kind)) contributes its own
    parameters by it."""
    table: Dict[Path, Tuple[str, str]] = {}
    for name, m in model.named_modules():
        path = tuple(name.split('.')) if name else ()
        prefix = f'{name}.' if name else ''
        for pname, (leaf, kind) in getattr(m, 'flax_leaves', {}).items():
            if getattr(m, pname, None) is not None:
                table[('params', *path, leaf)] = (prefix + pname, kind)
        kind = (CONV if isinstance(m, nn.Conv2d) else
                DECONV if isinstance(m, nn.ConvTranspose2d) else
                DENSE if isinstance(m, nn.Linear) else '')
        if kind:
            table[('params', *path, 'kernel')] = (prefix + 'weight', kind)
            if m.bias is not None:
                table[('params', *path, 'bias')] = (prefix + 'bias', '')
        elif isinstance(m, nn.BatchNorm2d):
            table[('params', *path, 'scale')] = (prefix + 'weight', '')
            table[('params', *path, 'bias')] = (prefix + 'bias', '')
            table[('batch_stats', *path, 'mean')] = (prefix + 'running_mean',
                                                     '')
            table[('batch_stats', *path, 'var')] = (prefix + 'running_var',
                                                    '')
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            table[('params', *path, 'scale')] = (prefix + 'weight', '')
            table[('params', *path, 'bias')] = (prefix + 'bias', '')
    return table


def _flatten(tree, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def flax_to_state_dict(variables, model: nn.Module) -> Dict[str, torch.Tensor]:
    """tpudet variables -> a complete fp32 ``state_dict`` for ``model``.

    Raises ``KeyError`` for a leaf with no place in ``model`` or a tensor of
    ``model`` that no leaf fills (but for those under ``model``'s
    ``flax_optional`` subtrees when ``variables`` holds none of them: those
    keep their values), ``ValueError`` for a shape mismatch."""
    optional = getattr(model, 'flax_optional', ())
    given = any(name in variables.get(c, {}) for name in optional
                for c in ('params', 'batch_stats'))
    absent = () if given else tuple(f'{name}.' for name in optional)
    like = model.state_dict()
    out = _tensors(variables, leaf_table(model), {
        k: v for k, v in like.items() if not k.startswith(absent)},
        type(model).__name__)
    out.update({k: v for k, v in like.items() if k.startswith(absent)})
    return out


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Load tpudet variables into ``model`` (strict)."""
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    return model


KERNEL_RANK = {CONV: 4, DENSE: 2, DECONV: 4, DEFORM: 3}  # flax's rank


def flax_shape(shape, kind: str) -> Tuple[int, ...]:
    """The flax shape of a tensor of torch ``shape`` with ``leaf_table``'s
    ``kind``."""
    shape = tuple(shape)
    if kind == CONV:
        return shape[2:] + shape[1::-1]
    if kind == DECONV:
        return shape[2:] + shape[:2]
    if kind == DENSE:
        return shape[::-1]
    if kind == DEFORM:
        return (shape[2] * shape[3], shape[1], shape[0])
    return shape


def _from_flax_layout(value: np.ndarray, kind: str) -> np.ndarray:
    """HWIO -> OIHW on the last four axes of a conv kernel leaf, (in, out)
    -> (out, in) on the last two of a Dense one, (H, W, in, out) -> (in,
    out, H, W) spatially flipped for a ConvTranspose one, (K*K, in, out) ->
    (out, in, K, K) for a deformable one (a leading axis, as in Adam's
    stacked (m, v) buffers, is kept)."""
    if not kind:
        return value
    n = value.ndim
    lead = tuple(range(n - KERNEL_RANK[kind]))
    if kind == DEFORM:
        k = int(round(value.shape[-3] ** 0.5))
        value = np.transpose(value, lead + (n - 1, n - 2, n - 3))
        return value.reshape(value.shape[:-1] + (k, k))
    if kind == DENSE:
        return np.transpose(value, lead + (n - 1, n - 2))
    if kind == DECONV:
        return np.flip(np.transpose(value, lead + (n - 2, n - 1, n - 4,
                                                   n - 3)), (-2, -1))
    return np.transpose(value, lead + (n - 1, n - 2, n - 4, n - 3))


def _to_flax_layout(value: np.ndarray, kind: str) -> np.ndarray:
    """OIHW -> HWIO, (out, in) -> (in, out), flipped (in, out, H, W) ->
    (H, W, in, out), (out, in, K, K) -> (K*K, in, out) (inverse of the
    above)."""
    if not kind:
        return value
    if kind == DEFORM:
        value = value.reshape(value.shape[:-2] + (-1,))
        n = value.ndim
        return np.transpose(value, tuple(range(n - 3)) + (n - 1, n - 2,
                                                           n - 3))
    n = value.ndim
    lead = tuple(range(n - KERNEL_RANK[kind]))
    if kind == DENSE:
        return np.transpose(value, lead + (n - 1, n - 2))
    if kind == DECONV:
        return np.transpose(np.flip(value, (-2, -1)),
                            lead + (n - 2, n - 1, n - 4, n - 3))
    return np.transpose(value, lead + (n - 2, n - 1, n - 3, n - 4))


def _tree(table, tensors: Dict[str, torch.Tensor], collection: str) -> Dict:
    """The flax tree of ``collection`` from tensors keyed by torch name."""
    tree: Dict = {}
    for path, (key, kind) in table.items():
        if path[0] != collection:
            continue
        node = tree
        for p in path[1:-1]:
            node = node.setdefault(p, {})
        value = tensors[key].detach().float().cpu().numpy()
        # a copy: on the CPU ``numpy()`` shares the live tensor's memory
        node[path[-1]] = np.array(_to_flax_layout(value, kind), order='C')
    return tree


def state_dict_to_flax(model: nn.Module) -> Dict:
    """``model``'s weights as a tpudet ``{'params', 'batch_stats'}`` tree of
    fp32 numpy arrays (conv kernels HWIO, Dense kernels (in, out),
    ConvTranspose kernels (H, W, in, out))."""
    table = leaf_table(model)
    sd = model.state_dict()
    return {'params': _tree(table, sd, 'params'),
            'batch_stats': _tree(table, sd, 'batch_stats')}


def _tensors(tree, table, like: Dict[str, torch.Tensor], what: str,
             prefix: Path = ()) -> Dict[str, torch.Tensor]:
    """tpudet leaves (under ``prefix``, the collection when ``tree`` is one
    collection's tree) -> fp32 tensors keyed and shaped as ``like``, on its
    devices, strictly: a leaf with no place or a shape that does not fit
    raises, and so does a float tensor of ``like`` that no leaf fills.
    Tensors that are not floating point (``num_batches_tracked``) start at
    zero."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree, prefix).items():
        if path not in table:
            raise KeyError(f'flax leaf {"/".join(path)} has no place in '
                           f'{what}')
        key, kind = table[path]
        if kind and value.ndim < KERNEL_RANK[kind]:
            raise ValueError(f'{"/".join(path)}: expected a {kind} kernel '
                             f'of rank {KERNEL_RANK[kind]}, got shape '
                             f'{value.shape}')
        value = _from_flax_layout(value, kind)
        ref = like[key]
        if value.shape != tuple(ref.shape):
            raise ValueError(f'{"/".join(path)}: shape {value.shape} does '
                             f'not fit {key} {tuple(ref.shape)}')
        out[key] = torch.from_numpy(np.array(
            value, dtype=np.float32, order='C')).to(ref.device)
    for key, ref in like.items():
        if key in out:
            continue
        if ref.is_floating_point():
            raise KeyError(f'{key} of {what} is not in the flax variables')
        out[key] = torch.zeros_like(ref)
    return out


def train_state_from_flax(flax_state, model: nn.Module, opt_cfg):
    """A tpudet ``TrainState`` (numpy or jax leaves; anything with ``step``,
    ``params``, ``batch_stats``, ``ema_params``, ``ema_batch_stats`` and
    ``opt_state.momentum_buf``) -> the port's ``TrainState`` for
    ``model``: params and BN statistics are loaded into the model (strict),
    the EMA copies and momentum buffers are new tensors on its device."""
    from ..train.train_state import create_train_state
    load_flax_variables(model, {'params': flax_state.params,
                                'batch_stats': flax_state.batch_stats})
    state = create_train_state(model, opt_cfg)
    table = leaf_table(model)
    state.ema_params = _tensors(flax_state.ema_params, table, state.params,
                                'ema_params', ('params',))
    state.ema_batch_stats = _tensors(flax_state.ema_batch_stats, table,
                                     state.batch_stats, 'ema_batch_stats',
                                     ('batch_stats',))
    state.opt_state = state.opt_state._replace(momentum_buf=_tensors(
        flax_state.opt_state.momentum_buf, table,
        state.opt_state.momentum_buf, 'momentum_buf', ('params',)))
    state.step.fill_(int(np.asarray(flax_state.step)))
    return state


def train_state_to_flax(state, model: nn.Module) -> SimpleNamespace:
    """The port's ``TrainState`` -> tpudet's leaves, as numpy trees with
    the ``TrainState`` attribute names (``step``, ``params``,
    ``batch_stats``, ``ema_params``, ``ema_batch_stats``,
    ``opt_state.momentum_buf``); ``train_state_from_flax`` takes it back."""
    table = leaf_table(model)
    return SimpleNamespace(
        step=np.asarray(int(state.step), np.int32),
        params=_tree(table, state.params, 'params'),
        batch_stats=_tree(table, state.batch_stats, 'batch_stats'),
        ema_params=_tree(table, state.ema_params, 'params'),
        ema_batch_stats=_tree(table, state.ema_batch_stats, 'batch_stats'),
        opt_state=SimpleNamespace(momentum_buf=_tree(
            table, state.opt_state.momentum_buf, 'params')))


def _truncated_normal(rng: np.random.RandomState, shape, std: float):
    """N(0, std^2) cut at +-2 std, redrawn outside (flax's truncated
    normal)."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2
    return (x * std).astype(np.float32)


def _draw_kernel(rng: np.random.RandomState, init, hwio) -> np.ndarray:
    """A conv kernel (HWIO; I is cin / groups) drawn by flax's
    initializer ``init``: ``'he_normal'`` or ``'lecun_normal'`` (flax's
    default; truncated normals of variance 2 or 1 over fan-in),
    ``'xavier_uniform'`` (uniform, fan-average), ``'zeros'`` or
    ``('normal', std)``."""
    kh, kw, cin, cout = hwio
    if init in ('he_normal', 'lecun_normal'):
        # the std of the truncated draw corrected by 0.8796..., the std of
        # N(0, 1) cut at +-2
        gain = 2.0 if init == 'he_normal' else 1.0
        std = np.sqrt(gain / (kh * kw * cin)) / .87962566103423978
        return _truncated_normal(rng, hwio, std)
    if init == 'zeros':
        return np.zeros(hwio, np.float32)
    if init == 'xavier_uniform':
        limit = np.sqrt(6.0 / (kh * kw * (cin + cout)))
        return rng.uniform(-limit, limit, hwio).astype(np.float32)
    kind, std = init
    if kind != 'normal':
        raise ValueError(f'unknown kernel initializer {init!r}')
    return (rng.standard_normal(hwio) * std).astype(np.float32)


def random_flax_variables(model: nn.Module, seed: int = 0) -> Dict:
    """A tpudet variables tree for ``model`` drawn with tpudet's init from a
    numpy seed: each conv's and Dense layer's kernel and bias by the
    initializers it names (``layers.Conv``/``layers.Dense``/
    ``layers.ConvTranspose`` ``kernel_init``, ``bias_init``; a plain
    ``nn.Conv2d`` takes ``he_normal`` and a zero bias), a deformable
    conv's kernel ``he_normal`` (fan-in K*K*in) and its bias 0, BatchNorm,
    GroupNorm and LayerNorm scale 1, bias 0, mean 0, var 1, and a raw
    leaf the constant its module's ``leaf_init`` names (0 if none). A
    Dense kernel (in, out) is drawn as a 1 x 1 conv's, a ConvTranspose
    kernel in its flax shape (H, W, in, out), a deformable one as the (K,
    K, in, out) conv kernel it reshapes. Kernels are drawn in the order of
    their sorted flax paths."""
    rng = np.random.RandomState(seed)
    modules = dict(model.named_modules())
    sd = model.state_dict()
    tree: Dict = {}
    for path, (key, kind) in sorted(leaf_table(model).items()):
        module = modules['.'.join(path[1:-1])]
        shape = tuple(sd[key].shape)
        leaf = path[-1]
        if kind == CONV:
            value = _draw_kernel(
                rng, getattr(module, 'kernel_init', 'he_normal'),
                (shape[2], shape[3], shape[1], shape[0]))
        elif kind == DECONV:
            # flax's fan-in of a ConvTranspose kernel is H * W * in
            value = _draw_kernel(rng, module.kernel_init,
                                 flax_shape(shape, kind))
        elif kind == DENSE:
            value = _draw_kernel(
                rng, module.kernel_init, (1, 1, shape[1], shape[0]))[0, 0]
        elif kind == DEFORM:
            value = _draw_kernel(
                rng, 'he_normal', (shape[2], shape[3], shape[1], shape[0])
            ).reshape(flax_shape(shape, kind))
        elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d,
                                 nn.Linear)):  # a bias
            value = np.broadcast_to(np.asarray(
                getattr(module, 'bias_init', 0.), np.float32), shape).copy()
        elif leaf in getattr(module, 'leaf_init', {}):
            value = np.full(shape, module.leaf_init[leaf], np.float32)
        elif leaf in ('scale', 'var'):
            value = np.ones(shape, np.float32)
        else:
            value = np.zeros(shape, np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree
