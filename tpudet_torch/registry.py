"""Registry + config-driven object construction (the port's own copy of
``tpudet/registry.py``, which is pure Python).

The extension API of the reference framework is its registry/config system
(reference: mmdet/models/builder.py:6-14, mmdet/datasets/builder.py:22-23):
config files name registry keys via ``type=...`` and builders instantiate the
object graph.  We reproduce those semantics with a dependency-free Registry.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A string -> class/callable registry.

    Mirrors mmcv's ``Registry`` surface used by the reference: decorator-based
    registration, ``get``, and ``build`` via :func:`build_from_cfg`.
    Supports parent/child scoping the same way configs use ``Parent.Child``
    keys, though the flat form covers everything the reference configs need.
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    def __len__(self):
        return len(self._module_dict)

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return f'Registry(name={self._name}, items={list(self._module_dict)})'

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name=None, force=False, module=None):
        """Register a module class/function.

        Usable as ``@REG.register_module()``, ``@REG.register_module('Name')``
        or ``REG.register_module(module=cls)``.
        """
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module, name=None, force=False):
        if name is None:
            names = [module.__name__]
        elif isinstance(name, str):
            names = [name]
        else:
            names = list(name)
        for key in names:
            if not force and key in self._module_dict:
                raise KeyError(f'{key} is already registered in {self._name}')
            self._module_dict[key] = module

    def build(self, cfg: Dict, **default_args) -> Any:
        return build_from_cfg(cfg, self, default_args or None)


def build_from_cfg(cfg: Dict, registry: Registry,
                   default_args: Optional[Dict] = None) -> Any:
    """Instantiate an object from a ``dict(type=..., **kwargs)`` config.

    Same contract as mmcv's builder: ``type`` may be a registry key or a
    class; ``default_args`` fill in missing keys.
    """
    if not isinstance(cfg, dict):
        raise TypeError(f'cfg must be a dict, got {type(cfg)}')
    if 'type' not in cfg:
        if default_args is None or 'type' not in default_args:
            raise KeyError(f'cfg must contain the key "type", got {cfg}')
    args = dict(cfg)
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)

    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not in the {registry.name} registry')
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or class, got {type(obj_type)}')
    return obj_cls(**args)


# The reference aliases a single MODELS registry to
# BACKBONES/NECKS/HEADS/DETECTORS (mmdet/models/builder.py:6-14); the port
# registers only the modules of the ported slices.
MODELS = Registry('models')
BACKBONES = MODELS
NECKS = MODELS
HEADS = MODELS
DETECTORS = MODELS

DATASETS = Registry('datasets')
PIPELINES = Registry('pipelines')
