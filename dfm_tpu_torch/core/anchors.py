"""3D anchor generation (numpy; anchors are constants of the grid).

Port of `dfm_tpu/core/anchors.py` `Anchor3DRangeGenerator`: anchors on
a BEV grid by endpoint-inclusive linspace over per-size ranges, layout
(1, Ny, Nx, num_sizes, num_rots, 7); and `AlignedAnchor3DRangeGenerator`
(`:95-123`), whose centres sit half a voxel inside the range (MultiViewDfM's
3D sample grid).
"""

import numpy as np

__all__ = ['Anchor3DRangeGenerator', 'AlignedAnchor3DRangeGenerator']


class Anchor3DRangeGenerator:
    def __init__(self, ranges, sizes=((3.9, 1.6, 1.56),),
                 rotations=(0.0, 1.5707963)):
        if len(ranges) == 1:
            ranges = list(ranges) * len(sizes)
        if len(ranges) != len(sizes):
            raise ValueError('one anchor range per size expected')
        self.ranges = [list(r) for r in ranges]
        self.sizes = [list(s) for s in sizes]
        self.rotations = list(rotations)

    def anchors_single_range(self, feature_size, anchor_range, size):
        """(Nz, Ny, Nx, 1, num_rot, 7) anchors for one size/range."""
        if len(feature_size) == 2:
            feature_size = [1, feature_size[0], feature_size[1]]
        nz, ny, nx = feature_size
        z = np.linspace(anchor_range[2], anchor_range[5], nz,
                        dtype=np.float32)
        y = np.linspace(anchor_range[1], anchor_range[4], ny,
                        dtype=np.float32)
        x = np.linspace(anchor_range[0], anchor_range[3], nx,
                        dtype=np.float32)
        rot = np.asarray(self.rotations, dtype=np.float32)
        zz, yy, xx, rr = np.meshgrid(z, y, x, rot, indexing='ij')
        centers = np.stack([xx, yy, zz], axis=-1)
        sizes = np.broadcast_to(np.asarray(size, np.float32),
                                centers.shape[:-1] + (3,))
        anchors = np.concatenate([centers, sizes, rr[..., None]], axis=-1)
        return anchors[:, :, :, None, :, :]

    def grid_anchors(self, featmap_size):
        """(1, Ny, Nx, num_sizes, num_rots, 7) float32."""
        return np.concatenate(
            [self.anchors_single_range(featmap_size, r, s)
             for r, s in zip(self.ranges, self.sizes)], axis=-3)


class AlignedAnchor3DRangeGenerator(Anchor3DRangeGenerator):
    """Anchor centres at voxel centres: the range cut into Nz x Ny x Nx
    cells (float32 cell sizes), linspace from half a cell inside each end
    (reference anchor_3d_generator.py:225+)."""

    def anchors_single_range(self, feature_size, anchor_range, size):
        if len(feature_size) == 2:
            feature_size = [1, feature_size[0], feature_size[1]]
        nz, ny, nx = feature_size
        ar = np.asarray(anchor_range, np.float32)
        vz = (ar[5] - ar[2]) / nz
        vy = (ar[4] - ar[1]) / ny
        vx = (ar[3] - ar[0]) / nx
        z = np.linspace(ar[2] + vz / 2, ar[5] - vz / 2, nz, dtype=np.float32)
        y = np.linspace(ar[1] + vy / 2, ar[4] - vy / 2, ny, dtype=np.float32)
        x = np.linspace(ar[0] + vx / 2, ar[3] - vx / 2, nx, dtype=np.float32)
        rot = np.asarray(self.rotations, dtype=np.float32)
        zz, yy, xx, rr = np.meshgrid(z, y, x, rot, indexing='ij')
        centers = np.stack([xx, yy, zz], axis=-1)
        sizes = np.broadcast_to(np.asarray(size, np.float32),
                                centers.shape[:-1] + (3,))
        anchors = np.concatenate([centers, sizes, rr[..., None]], axis=-1)
        return anchors[:, :, :, None, :, :]
