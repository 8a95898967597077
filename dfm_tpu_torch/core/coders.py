"""DeltaXYZWLHR box decode. Port of `dfm_tpu/core/coders.py:34`."""

import torch

__all__ = ['delta_xyzwlhr_decode']


def delta_xyzwlhr_decode(anchors, deltas):
    """Decode (..., 7) deltas on (..., 7) anchors back to boxes."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = deltas.unbind(-1)
    za = za + ha / 2
    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    lg = torch.exp(lt) * la
    wg = torch.exp(wt) * wa
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    return torch.stack([xg, yg, zg, wg, lg, hg, rg], dim=-1)
