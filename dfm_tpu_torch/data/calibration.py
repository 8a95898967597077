"""KITTI camera calibration with augmentation tracking (host-side numpy).

A copy of `dfm_tpu/data/calibration.py`, the equivalent of the
reference's `Calibration`
(mmdet3d/core/camera/calibration.py:31-333): P2/R0/V2C matrices whose
intrinsics are *mutated in lock-step with image augmentations*
(scale / crop / horizontal flip), plus the lidar / pseudo-lidar / rect /
image projections used by the DfM pipeline.

Pseudo-LiDAR frame: (x, y, z)_pl = (z, -x, -y)_rect.
"""

import dataclasses

import numpy as np

__all__ = ['Calibration']


@dataclasses.dataclass
class Calibration:
    P2: np.ndarray                 # (3, 4) camera projection
    R0: np.ndarray = None          # (3, 3) rectification
    V2C: np.ndarray = None         # (3, 4) velodyne -> camera
    flipped: bool = False

    def __post_init__(self):
        self.P2 = np.asarray(self.P2, np.float64).reshape(3, 4)
        if self.R0 is None:
            self.R0 = np.eye(3)
        if self.V2C is None:
            self.V2C = np.eye(4)[:3]
        self.R0 = np.asarray(self.R0, np.float64).reshape(3, 3)
        self.V2C = np.asarray(self.V2C, np.float64).reshape(3, 4)

    # --- augmentation tracking (reference calibration.py:88-154) ---
    def scale(self, factor):
        """Image resized by `factor`: P2 rows 0-1 scale."""
        self.P2 = self.P2.copy()
        self.P2[:2] *= factor

    def offset(self, offset_x, offset_y):
        """Image cropped at (offset_x, offset_y): principal point shifts;
        the translation column compensates to keep 3D->2D consistent."""
        K = self.P2[:3, :3].copy()
        inv_K = np.linalg.inv(K)
        T = inv_K @ self.P2  # [I | t] in camera units
        K[0, 2] -= offset_x
        K[1, 2] -= offset_y
        self.P2 = K @ T

    def fliplr(self, image_w):
        """Horizontal flip (mirror across the camera's y-z plane,
        reference `flipl`, calibration.py:116-132): decompose P = K [I|t],
        negate t_x, mirror the principal point, recompose."""
        assert not self.flipped
        K = self.P2[:3, :3].copy()
        T = np.linalg.inv(K) @ self.P2  # [I | t]
        T[0, 3] *= -1
        K[0, 2] = image_w - 1 - K[0, 2]
        self.P2 = K @ T
        self.flipped = not self.flipped

    # --- projections ---
    @property
    def cam2img(self):
        """(4, 4) homogeneous intrinsics."""
        out = np.eye(4)
        out[:3, :4] = self.P2
        return out.astype(np.float32)

    def lidar_to_rect(self, pts):
        """(N, 3) velodyne -> rectified camera."""
        homo = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
        return (homo @ self.V2C.T) @ self.R0.T

    def rect_to_lidar_pseudo(self, pts_rect):
        """rect -> pseudo-lidar (z, -x, -y)."""
        return np.stack(
            [pts_rect[:, 2], -pts_rect[:, 0], -pts_rect[:, 1]], axis=1)

    def lidar_pseudo_to_rect(self, pts_pl):
        """pseudo-lidar -> rect (-y, -z, x)."""
        return np.stack(
            [-pts_pl[:, 1], -pts_pl[:, 2], pts_pl[:, 0]], axis=1)

    def rect_to_img(self, pts_rect):
        """(N, 3) rect -> (N, 2) pixels + (N,) depth."""
        homo = np.concatenate(
            [pts_rect, np.ones_like(pts_rect[:, :1])], axis=1)
        uvw = homo @ self.P2.T
        depth = uvw[:, 2]
        uv = uvw[:, :2] / uvw[:, 2:3]
        return uv, depth

    def img_to_rect(self, u, v, depth):
        """Pixels + depth -> rect frame (closed form with P2)."""
        cu, cv = self.P2[0, 2], self.P2[1, 2]
        fu, fv = self.P2[0, 0], self.P2[1, 1]
        tx = self.P2[0, 3] / (-fu)
        ty = self.P2[1, 3] / (-fv)
        x = ((u - cu) * depth) / fu + tx
        y = ((v - cv) * depth) / fv + ty
        return np.stack([x, y, depth], axis=1)
