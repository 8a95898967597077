"""DeltaXYZWLHR box coder. Port of `dfm_tpu/core/coders.py:13-52`."""

import torch

__all__ = ['delta_xyzwlhr_encode', 'delta_xyzwlhr_decode']


def delta_xyzwlhr_encode(anchors, gt_boxes):
    """Encode (..., 7) gt boxes as deltas w.r.t. (..., 7) anchors."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xg, yg, zg, wg, lg, hg, rg = gt_boxes.unbind(-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    return torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal,
                        (zg - za) / ha, torch.log(wg / wa),
                        torch.log(lg / la), torch.log(hg / ha), rg - ra],
                       dim=-1)


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
