"""Detector builder: a config's `model = dict(type=..., ...)` -> the
port's `DfMConfig` (and DfMFull's `ATSS2DConfig`).

Port of `dfm_tpu/models/builder.py:28-62` (`_mk_cfg`, `_build_dfm`,
`_build_dfm_full`) for the two types the port runs, `DfM` and
`DfMFull`. Both evaluate the DfM student alone, so `build_detector`
gives the student's config for both; `atss_config` gives DfMFull's 2D
head its config from the model's `atss` entry, and the train CLI
(`tools/train.py`) builds `DfMFull` from the two and restores its teacher
from `teacher_checkpoint`. Keys that are no field of `DfMConfig` are
ignored by `build_detector`, as `_mk_cfg` ignores them; `unused_keys`
names them (for the repo's DfM configs: the type and DfMFull's `atss`
and `teacher_checkpoint`, which only training reads).
"""

import dataclasses

from .detectors.dfm import DfMConfig
from .heads.atss2d import ATSS2DConfig

__all__ = ['build_detector', 'atss_config', 'unused_keys', 'PORTED_TYPES']

PORTED_TYPES = ('DfM', 'DfMFull')


def _mk_cfg(cls, d):
    """Dataclass `cls` from dict `d`, ignoring unknown keys; lists become
    tuples (of tuples), as the JAX builder makes them."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[k] = v
    return cls(**kwargs)


def _as_dict(model_cfg):
    return model_cfg.to_dict() if hasattr(model_cfg, 'to_dict') \
        else dict(model_cfg)


def unused_keys(model_cfg):
    """The keys of `model_cfg` that `build_detector` ignores."""
    fields = {f.name for f in dataclasses.fields(DfMConfig)}
    return sorted(k for k in _as_dict(model_cfg) if k not in fields)


def build_detector(model_cfg):
    """`model_cfg` (a dict or `Config` with a `type`) -> `DfMConfig`.
    Raises NotImplementedError for a type the port does not run."""
    d = _as_dict(model_cfg)
    if 'type' not in d:
        raise KeyError('model config has no type')
    kind = d['type']
    if kind not in PORTED_TYPES:
        raise NotImplementedError(
            f'model type {kind!r} is not ported to dfm_tpu_torch (ported: '
            f'{", ".join(PORTED_TYPES)})')
    return _mk_cfg(DfMConfig, d)


def atss_config(model_cfg):
    """DfMFull's `ATSS2DConfig` from the model config's `atss` dict
    (the defaults where it has none)."""
    atss = _as_dict(model_cfg).get('atss') or {}
    return _mk_cfg(ATSS2DConfig, _as_dict(atss))
