"""Carry tpudet weights across: a tpudet ``{'params', 'batch_stats'}`` tree
of numpy arrays -> the port's ``state_dict``.

The port's modules carry the flax names, so a leaf's path is its module
path: ``params/backbone/conv0/conv/kernel`` is ``backbone.conv0.conv.weight``.

- a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW); a conv ``bias`` is
  carried as it is;
- BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) become
  ``weight/bias/running_mean/running_var``.

Every leaf must find its tensor, with its shape, and every tensor of the
model must be reached: anything else raises. Nothing is dropped.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]


def leaf_table(model: nn.Module) -> Dict[Path, Tuple[str, bool]]:
    """``(collection, *module path, leaf)`` -> ``(state_dict key, is a conv
    kernel)`` for every tensor of ``model`` that tpudet holds."""
    table: Dict[Path, Tuple[str, bool]] = {}
    for name, m in model.named_modules():
        path = tuple(name.split('.')) if name else ()
        prefix = f'{name}.' if name else ''
        if isinstance(m, nn.Conv2d):
            table[('params', *path, 'kernel')] = (prefix + 'weight', True)
            if m.bias is not None:
                table[('params', *path, 'bias')] = (prefix + 'bias', False)
        elif isinstance(m, nn.BatchNorm2d):
            table[('params', *path, 'scale')] = (prefix + 'weight', False)
            table[('params', *path, 'bias')] = (prefix + 'bias', False)
            table[('batch_stats', *path, 'mean')] = (prefix + 'running_mean',
                                                     False)
            table[('batch_stats', *path, 'var')] = (prefix + 'running_var',
                                                    False)
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
    ``model`` that no leaf fills, ``ValueError`` for a shape mismatch."""
    table = leaf_table(model)
    target = model.state_dict()
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables).items():
        if path not in table:
            raise KeyError(f'flax leaf {"/".join(path)} has no place in '
                           f'{type(model).__name__}')
        key, is_kernel = table[path]
        if is_kernel:
            if value.ndim != 4:
                raise ValueError(f'{"/".join(path)}: expected an HWIO conv '
                                 f'kernel, got shape {value.shape}')
            value = np.transpose(value, (3, 2, 0, 1))
        want = tuple(target[key].shape)
        if value.shape != want:
            raise ValueError(f'{"/".join(path)}: shape {value.shape} does '
                             f'not fit {key} {want}')
        sd[key] = torch.from_numpy(np.ascontiguousarray(value,
                                                        dtype=np.float32))
    for key, tensor in target.items():
        if key.endswith('num_batches_tracked'):
            sd[key] = torch.zeros_like(tensor)
        elif key not in sd:
            raise KeyError(f'{key} of {type(model).__name__} is not in the '
                           f'flax variables')
    return sd


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Load tpudet variables into ``model`` (strict)."""
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    return model


def _truncated_normal(rng: np.random.RandomState, shape, std: float):
    """N(0, std^2) cut at +-2 std, redrawn outside (flax's truncated
    normal)."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2
    return (x * std).astype(np.float32)


def random_flax_variables(model: nn.Module, seed: int = 0) -> Dict:
    """A tpudet variables tree for ``model`` drawn with tpudet's init from a
    numpy seed: conv kernels ``he_normal`` (fan-in truncated normal), the
    head's pred convs N(0, 0.01^2) with the head's bias priors, BatchNorm
    scale 1, bias 0, mean 0, var 1."""
    rng = np.random.RandomState(seed)
    modules = dict(model.named_modules())
    sd = model.state_dict()
    tree: Dict = {}
    for path, (key, is_kernel) in sorted(leaf_table(model).items()):
        module = modules['.'.join(path[1:-1])]
        shape = tuple(sd[key].shape)
        leaf = path[-1]
        if is_kernel:
            kh, kw = shape[2], shape[3]
            hwio = (kh, kw, shape[1], shape[0])
            if module.bias is not None:  # a head pred conv
                value = (rng.standard_normal(hwio) * 0.01).astype(np.float32)
            else:
                # flax he_normal: std of the truncated draw corrected by
                # 0.8796..., the std of N(0, 1) cut at +-2
                std = np.sqrt(2.0 / (kh * kw * shape[1])) / .87962566103423978
                value = _truncated_normal(rng, hwio, std)
        elif leaf in ('scale', 'var'):
            value = np.ones(shape, np.float32)
        else:
            value = np.zeros(shape, np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = value
    head = getattr(model, 'bbox_head', None)
    if head is not None and hasattr(head, 'bias_prior'):
        for i in range(head.num_levels):
            tree['params']['bbox_head'][f'conv_pred{i}']['bias'] = \
                head.bias_prior(i)
    return tree
