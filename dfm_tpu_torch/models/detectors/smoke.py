"""SMOKE monocular 3D detector: DLA-34 + DLANeck + a CenterNet head.

Port of `dfm_tpu/models/detectors/smoke.py` (the reference's
`SMOKEMono3D`, `SMOKEMono3DHead` and `SMOKECoder`):

* `SMOKEHead`: two branches over the neck's map, each a 3x3 conv of 256
  channels with a bias (JAX hard-codes 256; `feat_channels` is not read),
  GroupNorm 32, ReLU and a biased 1x1 conv: `cls` (the clamped sigmoid
  heatmap) and `reg` (8 channels: depth offset, 2D centre offset, the
  dimension offsets through sigmoid - 0.5, the normalised orientation
  2-vector). Outputs are channels last, (B, h, w, ch) float32 views of the
  NCHW maps, as in the JAX package. Keys: bbox_head.{cls,reg}_{conv,gn,out}
  (JAX `{name}_conv`, `GroupNorm_0` / `_1`, `{name}_out`);
* `smoke_targets` / `smoke_loss`: the Gaussian heatmap of the gt centres
  (radius from a nominal 7.2 px/m, at least 2) and the first `max_objs`
  valid gts in their order (a stable sort, as `jnp.argsort`); the
  Gaussian focal loss plus 10 x the L1 of the decoded boxes' corners at
  the gt cells. In a process group the normalisers are the global batch's;
* `smoke_predict`: 3x3 local maxima of the heatmap, the top `topk` of the
  (y, x, class) order (ties to the lower index, as `lax.top_k`),
  `smoke_decode_at`. Unlike JAX's (one unbatched dict of sample 0, which
  JAX's own KITTI evaluation cannot read: ROADMAP.md section 3), it
  returns every sample's padded camera-frame detections: 'boxes3d'
  (B, topk, 7) bottom-centre, 'scores' (0 at or below `score_thr`),
  'labels', 'mask' (score above `score_thr`).
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.boxes import corners_cam
from ...core.transforms import points_img2cam
from ...parallel import dist as D
from ..backbones.dla import DLANet
from ..heads.center_head import gaussian_focal_loss, gaussian_radius
from ..heads.fcos_mono3d import pad44
from ..layers import Conv, GroupNorm
from ..necks.dla_neck import DLANeck

__all__ = ['SMOKEConfig', 'SMOKEHead', 'SMOKEMono3D', 'DLAMonoDetector',
           'smoke_decode_at', 'smoke_targets', 'smoke_loss', 'smoke_predict',
           'heatmap_peaks', 'gather_cells', 'gaussian_heatmap']

SMOKE_BRANCH_CHANNELS = 256


@dataclasses.dataclass(frozen=True)
class SMOKEConfig:
    """Mirrors configs/_base_/models/smoke.py hyperparameters."""
    num_classes: int = 3
    feat_channels: int = 256
    base_depth: Tuple[float, float] = (28.01, 16.32)
    base_dims: Tuple[Tuple[float, float, float], ...] = (
        (0.88, 1.73, 0.67), (1.78, 1.70, 0.58), (3.88, 1.63, 1.53))
    downsample: int = 4
    max_objs: int = 64
    topk: int = 100
    score_thr: float = 0.25
    use_dcn_neck: bool = True


class SMOKEHead(nn.Module):
    def __init__(self, cfg, cin=64):
        super().__init__()
        self.cfg = cfg
        ch = SMOKE_BRANCH_CHANNELS
        for name, cout in (('cls', cfg.num_classes), ('reg', 8)):
            setattr(self, f'{name}_conv', Conv(cin, ch, 3, bias=True))
            setattr(self, f'{name}_gn', GroupNorm(ch))
            setattr(self, f'{name}_out', Conv(ch, cout, 1, bias=True))

    def _branch(self, name, feat):
        x = F.relu(getattr(self, f'{name}_gn')(
            getattr(self, f'{name}_conv')(feat)))
        return getattr(self, f'{name}_out')(x).float()

    def forward(self, feat):
        """(B, C, h, w) -> dict(heatmap (B, h, w, classes), reg (B, h, w,
        8)), float32."""
        heatmap = torch.sigmoid(self._branch('cls', feat)).clamp(
            1e-4, 1 - 1e-4)
        reg = self._branch('reg', feat)
        ori = reg[:, 6:8]
        ori = ori / torch.linalg.vector_norm(ori, dim=1,
                                             keepdim=True).clamp(min=1e-6)
        reg = torch.cat([reg[:, :3], torch.sigmoid(reg[:, 3:6]) - 0.5, ori],
                        1)
        return dict(heatmap=heatmap.permute(0, 2, 3, 1),
                    reg=reg.permute(0, 2, 3, 1))


def smoke_decode_at(reg_at, points, labels, cam2img, cfg):
    """SMOKECoder.decode at feature-map points.

    Args:
        reg_at: (..., K, 8); points: (..., K, 2) feature-map (x, y);
        labels: (..., K); cam2img: (..., 4, 4).

    Returns:
        (..., K, 7) camera-frame boxes (x, y bottom, z, l, h, w, yaw).
    """
    depth = reg_at[..., 0] * cfg.base_depth[1] + cfg.base_depth[0]
    c2d = (points + reg_at[..., 1:3]) * cfg.downsample
    loc = points_img2cam(torch.cat([c2d, depth[..., None]], -1), cam2img)
    base = torch.tensor(cfg.base_dims, dtype=torch.float32,
                        device=reg_at.device)[labels]
    dims = torch.exp(reg_at[..., 3:6]) * base
    yaw = torch.atan2(reg_at[..., 6], reg_at[..., 7]) + \
        torch.atan2(loc[..., 0], loc[..., 2])
    bottom = torch.stack([loc[..., 0], loc[..., 1] + dims[..., 1] / 2,
                          loc[..., 2]], -1)
    return torch.cat([bottom, dims, yaw[..., None]], -1)


def gaussian_heatmap(xi, yi, radius, valid, labels, num_classes, ny, nx):
    """(B, ny, nx, classes) max-composited Gaussians of radius `radius`
    (B, G) at the integer cells (xi, yi), zero beyond the radius and for
    gts not `valid`."""
    dev = radius.device
    gy = torch.arange(ny, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(nx, dtype=torch.float32, device=dev)[None, :]
    d2 = (gx - xi[..., None, None]) ** 2 + (gy - yi[..., None, None]) ** 2
    sigma = ((2 * radius + 1) / 6.0)[..., None, None]
    gauss = torch.where((d2 <= radius[..., None, None] ** 2) &
                        valid[..., None, None],
                        torch.exp(-d2 / (2 * sigma ** 2)),
                        torch.zeros((), device=dev))
    return torch.stack([torch.where((labels == c)[..., None, None], gauss,
                                    torch.zeros((), device=dev)).amax(1)
                        for c in range(num_classes)], -1)


def gather_cells(dense, inds):
    """(B, h, w, C) channels-last map, (B, K) flat cell indices ->
    (B, K, C)."""
    b, h, w, c = dense.shape
    return torch.gather(dense.reshape(b, h * w, c), 1,
                        inds[..., None].expand(-1, -1, c))


def smoke_targets(gt_boxes_cam, centers2d, gt_labels, gt_mask, featmap_size,
                  cfg):
    """The Gaussian heatmap and centre cells of a batch (B, G, ...) ->
    (heatmap (B, h, w, classes), inds (B, K) flat cells, mask (B, K), order
    (B, K) gt indices), K = min(G, max_objs)."""
    ny, nx = featmap_size
    cx = centers2d[..., 0] / cfg.downsample
    cy = centers2d[..., 1] / cfg.downsample
    xi = torch.floor(cx).clamp(0, nx - 1).long()
    yi = torch.floor(cy).clamp(0, ny - 1).long()
    inside = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    valid = gt_mask.bool() & inside
    f = 7.2      # nominal focal / downsample scale surrogate for the radius
    wl = torch.stack([gt_boxes_cam[..., 4] * f, gt_boxes_cam[..., 3] * f],
                     -1)
    radius = gaussian_radius(wl, 0.7).clamp(min=2.0)
    heatmap = gaussian_heatmap(xi.float(), yi.float(), radius, valid,
                               gt_labels, cfg.num_classes, ny, nx)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1,
                          stable=True)[..., :cfg.max_objs]
    inds = yi.gather(-1, order) * nx + xi.gather(-1, order)
    return heatmap, inds, valid.gather(-1, order), order


def smoke_loss(outputs, gt, cfg, cam2img):
    """dict(loss_cls, loss_bbox) of the head's outputs and a gt dict
    ('gt_boxes_cam', 'centers2d', 'gt_labels', 'gt_mask'), `cam2img`
    (B, 3|4, 4) (reference smoke_mono3d_head.py:430-530)."""
    hm_pred, reg = outputs['heatmap'], outputs['reg']
    b, ny, nx, _ = hm_pred.shape
    boxes = gt['gt_boxes_cam'].float()
    heatmap, inds, msk, order = smoke_targets(
        boxes, gt['centers2d'].float(), gt['gt_labels'], gt['gt_mask'],
        (ny, nx), cfg)
    pts = torch.stack([(inds % nx).float(), (inds // nx).float()], -1)
    pred = smoke_decode_at(gather_cells(reg, inds), pts,
                           gt['gt_labels'].long().gather(1, order),
                           pad44(cam2img), cfg)
    gt_sel = boxes.gather(1, order[..., None].expand(-1, -1, 7))
    w = msk.float()[..., None, None]
    l1 = (torch.abs(corners_cam(pred) - corners_cam(gt_sel)) * w).sum(
        (1, 2, 3)) / (w.sum((1, 2, 3)) * 24).clamp(min=1.0)
    n = D.global_sum(torch.full((), float(b), device=l1.device))
    return dict(loss_cls=gaussian_focal_loss(hm_pred.float(), heatmap,
                                             dist_norm=True),
                loss_bbox=l1.sum() / n * 10.0)


def heatmap_peaks(hm, topk):
    """(B, h, w, C) heatmap -> the top `topk` 3x3 local maxima of each
    sample in (y, x, class) order, ties to the lower index (`lax.top_k`):
    (scores, labels, cells) each (B, topk)."""
    b, ny, nx, c = hm.shape
    hmax = F.max_pool2d(hm.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
    peaks = torch.where(hm >= hmax, hm, torch.zeros((), device=hm.device))
    scores, idx = torch.sort(peaks.reshape(b, -1), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :topk], idx[:, :topk]
    return scores, idx % c, torch.div(idx, c, rounding_mode='floor')


def smoke_predict(outputs, cam2img, cfg):
    """Padded camera-frame detections of every sample (see the module
    docstring); `cam2img` (B, 3|4, 4)."""
    with record_function('mono.predict'):
        nx = outputs['heatmap'].shape[2]
        scores, labels, pix = heatmap_peaks(outputs['heatmap'], cfg.topk)
        pts = torch.stack([(pix % nx).float(),
                           torch.div(pix, nx, rounding_mode='floor').float()],
                          -1)
        boxes = smoke_decode_at(gather_cells(outputs['reg'], pix), pts,
                                labels, pad44(cam2img), cfg)
        keep = scores > cfg.score_thr
        return dict(boxes3d=boxes,
                    scores=torch.where(keep, scores,
                                       torch.zeros((), device=keep.device)),
                    labels=labels, mask=keep)


class DLAMonoDetector(nn.Module):
    """DLA-34 -> DLANeck -> a head; `forward(img)` takes (B, H, W, 3)
    normalised images (channels last, as the JAX package) and returns the
    head's dict; `forward_train(img, cam2img, gt)` the loss (the train
    step's (inputs, cond, gt)); `predict(outs, img_hw, cam2img)` the
    padded detections. Keys: backbone.*, neck.*, bbox_head.*."""

    head_class = None

    def __init__(self, cfg, backbone_depth=34, dtype=torch.float32,
                 use_dcn=True):
        super().__init__()
        if backbone_depth != 34:
            raise ValueError(f'the DLA trunk is DLA-34 only, not '
                             f'{backbone_depth}')
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = DLANet()
        self.neck = DLANeck(use_dcn=use_dcn)
        self.bbox_head = self.head_class(cfg, self.neck.out_channels)

    def features(self, img):
        """(B, H, W, 3) -> the neck's (B, 64, H/4, W/4) map."""
        with record_function('mono.trunk'):
            feats = self.backbone(img.permute(0, 3, 1, 2).to(self.dtype))
        with record_function('mono.neck'):
            return self.neck(feats)

    def forward(self, img):
        feat = self.features(img)
        with record_function('mono.head'):
            return self.bbox_head(feat)

    def forward_train(self, img, cam2img, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and the loss -> (total, dict of terms);
        `generator` / `depth_pix_idx` (`TrainStep`'s) are not used."""
        losses = self.loss(self(img), gt, cam2img)
        return sum(losses.values()), losses


class SMOKEMono3D(DLAMonoDetector):
    head_class = SMOKEHead

    def __init__(self, cfg=None, backbone_depth=34, dtype=torch.float32):
        cfg = cfg or SMOKEConfig()
        super().__init__(cfg, backbone_depth, dtype, cfg.use_dcn_neck)

    def loss(self, outs, gt, cam2img):
        return smoke_loss(outs, gt, self.cfg, cam2img)

    def predict(self, outs, img_hw, cam2img):
        return smoke_predict(outs, cam2img, self.cfg)
