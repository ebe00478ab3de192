"""Python-file config system with ``_base_`` inheritance (the port's own
copy of ``tpudet/config.py``, which is pure Python).

Reproduces the mmcv ``Config`` semantics the reference depends on
(reference: configs/yolov5_ddp/yolov5s_coco_mosaic_16x4.py:19-23 uses
``_base_`` + ``_delete_=True``; tools/train.py uses ``--cfg-options`` dotted
overrides merged via ``merge_from_dict``):

- a config is a python file; top-level non-underscore variables are keys
- ``_base_`` (str or list[str]) names parent configs relative to the file
- dict values merge recursively; a child dict with ``_delete_=True``
  replaces the parent subtree instead of merging into it
- ``Config.merge_from_dict`` applies dotted-key overrides
"""
from __future__ import annotations

import copy
import os
import os.path as osp
from typing import Any, Dict

BASE_KEY = '_base_'
DELETE_KEY = '_delete_'
RESERVED_KEYS = ('filename', 'text')


class ConfigDict(dict):
    """dict with attribute access, raising informative AttributeError."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out


def _to_config_dict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_a_into_b(a: Dict, b: Dict) -> Dict:
    """Merge dict ``a`` (child/override) into dict ``b`` (parent/base)."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and not v.pop(DELETE_KEY, False):
            if not isinstance(b[k], dict):
                raise TypeError(
                    f'Cannot merge dict into non-dict for key "{k}": '
                    f'{type(b[k])}. Use _delete_=True to replace it.')
            b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = dict(v)
                v.pop(DELETE_KEY, None)
            b[k] = copy.deepcopy(v)
    return b


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    with open(filename) as f:
        code = f.read()
    namespace: Dict[str, Any] = {'__file__': filename}
    exec(compile(code, filename, 'exec'), namespace)
    return {
        k: v
        for k, v in namespace.items()
        if not k.startswith('__') and not callable(v)
        and not isinstance(v, type(os))
    }


def _load_with_bases(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    cfg_dict = _exec_pyfile(filename)
    base = cfg_dict.pop(BASE_KEY, None)
    if base is None:
        return cfg_dict
    if isinstance(base, str):
        base = [base]
    merged: Dict[str, Any] = {}
    cfg_dir = osp.dirname(filename)
    for b in base:
        parent = _load_with_bases(osp.join(cfg_dir, b))
        dup = set(merged) & set(parent)
        if dup:
            raise KeyError(f'Duplicate keys between _base_ files: {dup}')
        merged.update(parent)
    return _merge_a_into_b(cfg_dict, merged)


class Config:
    """Config object wrapping a ConfigDict, loaded from python files."""

    def __init__(self, cfg_dict: Dict = None, filename: str = None):
        if cfg_dict is None:
            cfg_dict = {}
        for k in RESERVED_KEYS:
            if k in cfg_dict:
                raise KeyError(f'{k} is a reserved key')
        object.__setattr__(self, '_cfg_dict', _to_config_dict(cfg_dict))
        object.__setattr__(self, '_filename', filename)

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        if not filename.endswith('.py'):
            raise ValueError('Only python-file configs are supported')
        cfg_dict = _load_with_bases(filename)
        return Config(cfg_dict, filename=filename)

    @staticmethod
    def fromstring(cfg_str: str) -> 'Config':
        namespace: Dict[str, Any] = {}
        exec(cfg_str, namespace)
        cfg_dict = {
            k: v
            for k, v in namespace.items() if not k.startswith('__')
        }
        return Config(cfg_dict)

    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setattr__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __setitem__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __repr__(self):
        return f'Config (path: {self._filename}): {self._cfg_dict!r}'

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def copy(self) -> 'Config':
        return Config(copy.deepcopy(dict(self._cfg_dict)), self._filename)

    def merge_from_dict(self, options: Dict[str, Any]):
        """Merge dotted-key overrides, e.g. ``{'model.backbone.scale': 'l'}``.

        Mirrors mmcv Config.merge_from_dict used by tools/train.py
        ``--cfg-options``.
        """
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split('.')
            for sub in keys[:-1]:
                d = d.setdefault(sub, {})
            d[keys[-1]] = v
        merged = _merge_a_into_b(option_cfg, dict(self._cfg_dict))
        object.__setattr__(self, '_cfg_dict', _to_config_dict(merged))

    def dump(self, file: str = None) -> str:
        import pprint
        text = pprint.pformat(dict(self._cfg_dict), width=100, sort_dicts=False)
        if file is not None:
            with open(file, 'w') as f:
                f.write(text)
        return text
