"""Reduced-depth evaluation of conv stacks on depth-banded volumes.

The port's own copy of `dfm_tpu/ops/reduced_depth.py` (numpy only).

The mono trunk's input volume is constant along depth outside a narrow
edge band (`ops/band_volume.py`). A conv stack applied to it gives an
output that near the edges equals the output on a shorter volume with
the same edges, and that is periodic in the interior (period = product
of the stack's transposed-conv strides). So the mono hourglass + depth
prediction can be evaluated exactly on a reduced volume of
Dr = 2 * (E + M + 2) + P slices (bottom edge, one canonical period, top
edge) and expanded back by index tiling, where M bounds the stack's
half receptive field and P its output period.

GroupNorm couples every slice; it stays exact when each reduced slice's
moments are weighted with its multiplicity (how many slices of the full
volume it stands for): edge slices count once, each slice of the
canonical period (D - 2 * bot) / P times.
"""

import numpy as np

__all__ = ['ReducedPlan', 'make_reduced_plan']


class ReducedPlan:
    """Index map and per-scale GroupNorm multiplicities.

    Attributes:
        d, dr: full / reduced depth.
        bot: bottom (= top) edge length in the reduced volume.
        period: interior period P of the stack output.
        expand_idx: (D,) int32, full[z] = reduced[expand_idx[z]].
        mid_mult: how many full slices one canonical-period slice
            stands for.
    """

    def __init__(self, d, e, m, period):
        bot = e + m + 2
        dr = 2 * bot + period
        if dr >= d or d % period or bot % period:
            raise ValueError(f'no reduction: D={d} Dr={dr}')
        self.d, self.dr, self.bot, self.period = d, dr, bot, period
        delta = d - dr
        if delta % period:
            raise ValueError('shift not period-aligned')
        z = np.arange(d)
        self.expand_idx = np.where(
            z < bot, z,
            np.where(z < d - bot - period, bot + (z - bot) % period,
                     z - delta)).astype(np.int32)
        self.mid_mult = (d - 2 * bot) // period

    def mult(self, scale):
        """(ceil(Dr / 2**scale),) float32 multiplicities at that
        downsampling scale. The middle multiplicity is the same at every
        scale: (D - 2 * bot) / P full slices collapse onto P canonical
        ones."""
        f = 2 ** scale
        bot, p = self.bot // f, max(self.period // f, 1)
        m = np.ones((self.dr + f - 1) // f, np.float32)
        m[bot:bot + p] = self.mid_mult
        return m


def make_reduced_plan(d, e=2, m=16, period=4):
    """Plan for the DfM mono stack (hourglass + pred: half receptive
    field 15 < 16, two transposed convs along z -> period 4). None when
    the volume is too short to profit; callers then run the dense
    stack."""
    try:
        return ReducedPlan(d, e, m, period)
    except ValueError:
        return None
