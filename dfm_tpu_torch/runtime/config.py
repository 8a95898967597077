"""Config system: python-file configs, `_base_` inheritance, CLI overrides.

A copy of `dfm_tpu/runtime/config.py`: nested-dict python configs (the
repo's `configs/*.py`, read as data files), `_base_` composition,
`--cfg-options key=val` deep merge, dump for reproducibility. Model
assembly is `models/builder.py:build_detector`.
"""

import ast
import copy
import importlib.util
import json
import os

__all__ = ['load_config', 'merge_options', 'Config']


def _deep_merge(base, override):
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict) \
                and not v.pop('_delete_', False):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_py(path):
    spec = importlib.util.spec_from_file_location(
        'cfg_' + os.path.basename(path).replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items() if not k.startswith('__')}


def load_config(path):
    """Load a python config file, resolving `_base_` recursively."""
    ns = _load_py(path)
    bases = ns.pop('_base_', [])
    if isinstance(bases, str):
        bases = [bases]
    merged = {}
    for b in bases:
        base_path = os.path.join(os.path.dirname(path), b)
        merged = _deep_merge(merged, load_config(base_path).to_dict())
    merged = _deep_merge(merged, ns)
    return Config(merged)


def _parse_value(v):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def merge_options(cfg, options):
    """Apply `key.sub.key=value` CLI overrides (reference tools/train.py
    --cfg-options)."""
    d = cfg.to_dict() if isinstance(cfg, Config) else copy.deepcopy(cfg)
    for opt in options or []:
        key, _, val = opt.partition('=')
        parts = key.split('.')
        node = d
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return Config(d)


class Config:
    """Attribute-style access over a nested dict."""

    def __init__(self, data=None):
        object.__setattr__(self, '_data', copy.deepcopy(data or {}))

    def __getattr__(self, k):
        try:
            v = self._data[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v

    def __getitem__(self, k):
        return self.__getattr__(k)

    def __contains__(self, k):
        return k in self._data

    def get(self, k, default=None):
        v = self._data.get(k, default)
        return Config(v) if isinstance(v, dict) else v

    def to_dict(self):
        return copy.deepcopy(self._data)

    def keys(self):
        return self._data.keys()

    def dump(self, path):
        with open(path, 'w') as f:
            json.dump(self._data, f, indent=2, default=str)

    def __repr__(self):
        return f'Config({json.dumps(self._data, indent=2, default=str)})'
