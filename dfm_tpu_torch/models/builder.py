"""Detector builder: a config's `model = dict(type=..., ...)` -> the
port's config dataclass.

Port of `dfm_tpu/models/builder.py:28-69` (`_mk_cfg`, `_build_dfm`,
`_build_dfm_full`, `_build_mvdfm`) for the types the port runs: `DfM`
and `DfMFull` give `DfMConfig`, `MultiViewDfM` gives `MVDfMConfig`.
DfM and DfMFull evaluate the DfM student alone, so `build_detector`
gives the student's config for both; `atss_config` gives DfMFull's 2D
head its config from the model's `atss` entry, and the train CLI
(`tools/train.py`) builds `DfMFull` from the two and restores its teacher
from `teacher_checkpoint`. For DfM and DfMFull, keys that are no field of
`DfMConfig` are ignored by `build_detector`, as `_mk_cfg` ignores them;
`unused_keys` names them (for the repo's DfM configs: the type and
DfMFull's `atss` and `teacher_checkpoint`, which only training reads).
A `MultiViewDfM` config with a key that is no field of `MVDfMConfig`
is refused (ValueError).
"""

import dataclasses

from .detectors.dfm import DfMConfig
from .detectors.multiview_dfm import MVDfMConfig
from .heads.atss2d import ATSS2DConfig

__all__ = ['build_detector', 'atss_config', 'unused_keys', 'PORTED_TYPES']

PORTED_TYPES = ('DfM', 'DfMFull', 'MultiViewDfM')


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


def _config_class(kind):
    return MVDfMConfig if kind == 'MultiViewDfM' else DfMConfig


def unused_keys(model_cfg):
    """The keys of `model_cfg` that `build_detector` ignores."""
    d = _as_dict(model_cfg)
    fields = {f.name for f in dataclasses.fields(
        _config_class(d.get('type')))}
    return sorted(k for k in d if k not in fields)


def build_detector(model_cfg):
    """`model_cfg` (a dict or `Config` with a `type`) -> `DfMConfig`, or
    `MVDfMConfig` for MultiViewDfM. Raises NotImplementedError for a type
    the port does not run, ValueError for a MultiViewDfM key that is no
    field of `MVDfMConfig`."""
    d = _as_dict(model_cfg)
    if 'type' not in d:
        raise KeyError('model config has no type')
    kind = d['type']
    if kind not in PORTED_TYPES:
        raise NotImplementedError(
            f'model type {kind!r} is not ported to dfm_tpu_torch (ported: '
            f'{", ".join(PORTED_TYPES)})')
    if kind == 'MultiViewDfM':
        unknown = [k for k in unused_keys(d) if k != 'type']
        if unknown:
            raise ValueError(f'MultiViewDfM config keys that are no field '
                             f'of MVDfMConfig: {unknown}')
    return _mk_cfg(_config_class(kind), d)


def atss_config(model_cfg):
    """DfMFull's `ATSS2DConfig` from the model config's `atss` dict
    (the defaults where it has none)."""
    atss = _as_dict(model_cfg).get('atss') or {}
    return _mk_cfg(ATSS2DConfig, _as_dict(atss))
