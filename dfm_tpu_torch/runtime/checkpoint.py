"""Checkpoints: periodic save, max-keep, auto-resume.

Port of `dfm_tpu/runtime/checkpoint.py` (`CheckpointManager`; the
reference's mmcv CheckpointHook + `--auto-resume`). One file per step,
`<dir>/step_<step>.pth`, written by `torch.save` as
{'meta': {'step', 'config'}, 'state_dict', 'optimizer'} and read with
`torch.load(weights_only=True)`: tensors and plain containers only. The
'state_dict' holds the reference layout, so the evaluation's
`load_checkpoint` (`utils/weights.py`) takes the file as it is.
"""

import os
import re

import torch

__all__ = ['CheckpointManager']

_NAME = re.compile(r'^step_(\d+)\.pth$')


class CheckpointManager:
    def __init__(self, directory, max_keep=10):
        self.directory = os.path.abspath(directory)
        self.max_keep = max_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step):
        return os.path.join(self.directory, f'step_{int(step)}.pth')

    def steps(self):
        """The saved steps, ascending."""
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step, model, optimizer, config=None):
        """Write step `step` (atomically: a temporary file, then a
        rename) unless it exists; then keep the newest `max_keep`."""
        if step in self.steps():
            return self.path(step)
        ckpt = dict(meta=dict(step=int(step), config=config or {}),
                    state_dict=model.state_dict(),
                    optimizer=optimizer.state_dict())
        tmp = self.path(step) + '.tmp'
        torch.save(ckpt, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.max_keep]:
            os.remove(self.path(old))
        return self.path(step)

    def load(self, step=None):
        """The checkpoint dict of `step` (default: the latest), or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location='cpu',
                          weights_only=True)

    def restore(self, model, optimizer=None, step=None):
        """Load `step` (default: the latest) into `model` (and
        `optimizer`); returns the step restored, or None if there is
        none."""
        ckpt = self.load(step)
        if ckpt is None:
            return None
        model.load_state_dict(ckpt['state_dict'], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(ckpt['optimizer'])
        return int(ckpt['meta']['step'])
