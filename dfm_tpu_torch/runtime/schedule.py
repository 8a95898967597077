"""Learning-rate schedules. Port of `dfm_tpu/runtime/schedule.py:15-45`.

`liga_schedule` is the reference's LIGALrUpdaterHook
(mmdet3d/core/hook/liga_lrupdater_hook.py:10-88): a cosine warmup
    k = ratio + (1 - ratio) * (1 - cos(pi * t / warmup_iters)) / 2
then a step decay at given iterations. A schedule is a plain function of
the update count; as in optax, the first update uses count 0. The
arithmetic is float32, as the JAX schedule's.
"""

import numpy as np

__all__ = ['liga_schedule', 'step_schedule']


def liga_schedule(base_lr, warmup_iters=464, warmup_ratio=0.1,
                  decay_steps=(), gamma=0.1):
    """count -> learning rate (a Python float): cosine warmup over
    `warmup_iters` updates, times `gamma` from each of `decay_steps`."""
    decay_steps = tuple(decay_steps)
    f32 = np.float32

    def fn(count):
        t = f32(count)
        k = f32(warmup_ratio) + f32(1 - warmup_ratio) * (
            f32(1) - np.cos(f32(np.pi) * np.minimum(t, f32(warmup_iters)) /
                            f32(max(warmup_iters, 1)))) / f32(2)
        warm = k if t < warmup_iters else f32(1)
        decay = f32(1)
        for s in decay_steps:
            decay = decay * (f32(gamma) if t >= s else f32(1))
        return float(f32(base_lr) * warm * decay)

    return fn


def step_schedule(base_lr, decay_steps=(), gamma=0.1):
    return liga_schedule(base_lr, warmup_iters=0, warmup_ratio=1.0,
                         decay_steps=decay_steps, gamma=gamma)
