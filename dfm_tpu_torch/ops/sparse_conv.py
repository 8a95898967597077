"""Sparse 3D convolutions of fixed capacity: the 0.05 m teacher's encoder.

Port of `dfm_tpu/ops/sparse_conv.py:43-278` (the reference's spconv
stack of `CustomSparseEncoder`). An active set is a capacity-padded,
sorted vector of flat voxel keys (z * Ny + y) * Nx + x with a validity
mask, dead slots holding INVALID (2**31 - 1, sorting last):

* `_unique_compact`: the sorted unique keys of candidates, the first
  `capacity` of them where there are more (the largest dropped), as
  JAX's sort + segment ranks keep them; each candidate's slot (its rank,
  >= capacity if dropped; -1 if invalid);
* `sparse_voxelize_mean`: hard voxelization (the first `max_points`
  points of a voxel in arrival order) into the capacity's voxels, their
  mean features;
* `neighbor_table`: each active site's 27 neighbours' slots (-1 absent),
  by `torch.searchsorted` in the sorted keys;
* `subm_conv`: out[v] = sum_k W_k feats[nbr[k, v]], one gather of (V, 27,
  C_in) rows and one matmul (absent neighbours read a zero row);
* `sparse_conv_downsample`: a strided SparseConv3d's output set (every
  site whose window meets an input) and its gather table;
* `inverse_table`: a SparseInverseConv3d's gather table;
* `sparse_to_dense`: the active features scattered into the dense grid.

Keys, masks and tables are int64 here (int32 in JAX) with JAX's values.
No Pallas kernel lies on these functions in JAX; a kernel for
`subm_conv` waits for a bench (ROADMAP).
"""

import numpy as np
import torch

__all__ = ['INVALID', 'flatten_key', 'unflatten_key', 'sparse_voxelize_mean',
           'neighbor_table', 'subm_conv', 'sparse_conv_downsample',
           'inverse_table', 'sparse_to_dense']

INVALID = 2147483647        # sorts last: dead slots and invalid queries


def flatten_key(z, y, x, grid):
    nz, ny, nx = grid
    return (z * ny + y) * nx + x


def unflatten_key(key, grid):
    nz, ny, nx = grid
    return key // (nx * ny), (key // nx) % ny, key % nx


def _unique_compact(keys, valid, capacity):
    """(N,) candidate keys (repeats allowed) and their validity ->
    ukeys (capacity,) sorted (INVALID padded), umask (capacity,), slot_of
    (N,): each valid candidate's rank among the unique valid keys (its
    slot; a rank >= capacity was dropped), -1 for an invalid one."""
    k = torch.where(valid, keys.long(), torch.full_like(keys.long(),
                                                        INVALID))
    uniq, inv = torch.unique(k, sorted=True, return_inverse=True)
    n_uniq = int(uniq.numel()) - int(bool((uniq == INVALID).any()))
    ukeys = torch.full((capacity,), INVALID, dtype=torch.long,
                       device=keys.device)
    kept = min(n_uniq, capacity)
    ukeys[:kept] = uniq[:kept]
    umask = torch.arange(capacity, device=keys.device) < kept
    slot_of = torch.where(k != INVALID, inv, torch.full_like(inv, -1))
    return ukeys, umask, slot_of


def sparse_voxelize_mean(points, point_mask, pcr, voxel_size, grid,
                         capacity, max_points=5):
    """Hard voxelization (`Voxelization(max_num_points, max_voxels)` +
    HardSimpleVFE) of one sample's (P, C) points -> keys (V,) sorted,
    mean features (V, C) float32, vmask (V,). Indices are floor((p - lo)
    / size) (divisions by tensors, as XLA divides)."""
    nz, ny, nx = grid
    dev = points.device
    lo = torch.as_tensor(np.asarray(pcr, np.float32)[:3], device=dev)
    size = torch.as_tensor(np.asarray(voxel_size, np.float32), device=dev)
    idx = torch.floor((points[:, :3].float() - lo) / size).long()
    ix, iy, iz = idx.unbind(-1)
    inside = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) &
              (iz < nz) & point_mask.bool())
    key = flatten_key(iz, iy, ix, grid)
    keys, vmask, slot_of = _unique_compact(key, inside, capacity)
    # each point's rank in its voxel, in arrival order
    p = points.shape[0]
    sk_all = torch.where(inside, key, torch.full_like(key, INVALID))
    order = torch.argsort(sk_all, stable=True)
    sk = sk_all[order]
    pos = torch.arange(p, device=dev)
    is_start = torch.ones_like(inside)
    is_start[1:] = sk[1:] != sk[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos,
                                         torch.zeros_like(pos)), 0)[0]
    rank = torch.empty_like(pos).scatter_(0, order, pos - seg_start)
    # a voxel past the capacity goes to the dump slot with the rest
    keep = inside & (rank < max_points) & (slot_of >= 0) & \
        (slot_of < capacity)
    tgt = torch.where(keep, slot_of, torch.full_like(slot_of, capacity))
    c = points.shape[-1]
    feats = torch.where(keep[:, None], points.float(),
                        torch.zeros((), device=dev))
    sums = torch.zeros((capacity + 1, c), device=dev).index_add_(0, tgt,
                                                                feats)
    cnts = torch.zeros(capacity + 1, device=dev).index_add_(
        0, tgt, keep.float())
    return keys, sums[:-1] / torch.clamp(cnts[:-1, None], min=1.0), vmask


def _offsets(kernel=(3, 3, 3)):
    kz, ky, kx = kernel
    return np.array([(dz - kz // 2, dy - ky // 2, dx - kx // 2)
                     for dz in range(kz) for dy in range(ky)
                     for dx in range(kx)], np.int64)


def _lookup(keys, vmask, q, ok):
    """The slots of queries `q` (valid where `ok`) in the sorted `keys`,
    -1 where absent."""
    slot = torch.searchsorted(keys, torch.where(
        ok, q, torch.full_like(q, INVALID))).clamp(0, keys.shape[0] - 1)
    hit = ok & (keys[slot] == q) & vmask[slot]
    return torch.where(hit, slot, torch.full_like(slot, -1))


def neighbor_table(keys, vmask, grid, kernel=(3, 3, 3)):
    """(K, V) slot of each active site's k^3 neighbours (z-major taps),
    -1 where absent: shared by the SubM convs of one active set."""
    z, y, x = unflatten_key(keys, grid)
    nz, ny, nx = grid
    offs = torch.as_tensor(_offsets(kernel), device=keys.device)
    zz, yy, xx = (z[None] + offs[:, :1], y[None] + offs[:, 1:2],
                  x[None] + offs[:, 2:])
    ok = ((zz >= 0) & (zz < nz) & (yy >= 0) & (yy < ny) & (xx >= 0) &
          (xx < nx) & vmask[None])
    return _lookup(keys, vmask, flatten_key(zz, yy, xx, grid), ok)


def subm_conv(feats, nbr, kernel_w):
    """out[v] = sum_k feats[nbr[k, v]] @ W_k: (V, C) features (dead slots
    0), (K, V_out) table, (K, C, C') tap-major weights -> (V_out, C') in
    the features' dtype (float32 sums for bfloat16 features)."""
    v, c = feats.shape
    fz = torch.cat([feats, feats.new_zeros((1, c))], 0)
    idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, v))
    g = fz[idx.t()]                                   # (V_out, K, C)
    acc = torch.float64 if feats.dtype == torch.float64 else torch.float32
    out = torch.matmul(g.reshape(g.shape[0], -1).to(acc),
                       kernel_w.reshape(-1, kernel_w.shape[-1]).to(acc))
    return out.to(feats.dtype)


def sparse_conv_downsample(keys, vmask, grid, stride, padding, capacity,
                           kernel=(3, 3, 3)):
    """A strided SparseConv3d's active-set map -> (out_keys (Vo,),
    out_mask, out_grid, gather (K, Vo)): gather[k, o] is the input slot
    feeding output o through tap k (-1 absent); output o covers the
    inputs at o * stride - padding + tap."""
    sz, sy, sx = stride
    pz, py, px = padding
    kz, ky, kx = kernel
    nz, ny, nx = grid
    og = ((nz + 2 * pz - kz) // sz + 1, (ny + 2 * py - ky) // sy + 1,
          (nx + 2 * px - kx) // sx + 1)
    z, y, x = unflatten_key(keys, grid)

    def out_range(i, p, s, k, n_out):
        return ((i + p - k + s) // s).clamp(min=0), \
            ((i + p) // s).clamp(max=n_out - 1)

    zlo, zhi = out_range(z, pz, sz, kz, og[0])
    ylo, yhi = out_range(y, py, sy, ky, og[1])
    xlo, xhi = out_range(x, px, sx, kx, og[2])
    ok = vmask & (zlo <= zhi) & (ylo <= yhi) & (xlo <= xhi)
    cand, cvalid = [], []
    for az in range((kz - 1) // sz + 1):
        for ay in range((ky - 1) // sy + 1):
            for ax in range((kx - 1) // sx + 1):
                cand.append(flatten_key(torch.minimum(zlo + az, zhi),
                                        torch.minimum(ylo + ay, yhi),
                                        torch.minimum(xlo + ax, xhi), og))
                cvalid.append(ok)
    out_keys, out_mask, _ = _unique_compact(torch.cat(cand),
                                            torch.cat(cvalid), capacity)
    zo, yo, xo = unflatten_key(out_keys, og)
    offs = torch.as_tensor(_offsets(kernel), device=keys.device)
    iz = zo[None] * sz - pz + offs[:, :1] + kz // 2
    iy = yo[None] * sy - py + offs[:, 1:2] + ky // 2
    ix = xo[None] * sx - px + offs[:, 2:] + kx // 2
    okq = ((iz >= 0) & (iz < nz) & (iy >= 0) & (iy < ny) & (ix >= 0) &
           (ix < nx) & out_mask[None])
    return out_keys, out_mask, og, _lookup(keys, vmask,
                                           flatten_key(iz, iy, ix, grid),
                                           okq)


def inverse_table(fine_keys, fine_mask, coarse_keys, coarse_mask,
                  fine_grid, coarse_grid, stride, padding, kernel=(3, 3, 3)):
    """A SparseInverseConv3d's (K, Vf) gather table into `coarse_keys`:
    fine site i reads coarse o = (i + padding - tap) / stride where that
    divides (-1 absent), for `subm_conv(coarse_feats, table, w)` at the
    fine set."""
    sz, sy, sx = stride
    pz, py, px = padding
    kz, ky, kx = kernel
    z, y, x = unflatten_key(fine_keys, fine_grid)
    ngz, ngy, ngx = coarse_grid
    offs = torch.as_tensor(_offsets(kernel), device=fine_keys.device)
    tz = z[None] + pz - (offs[:, :1] + kz // 2)
    ty = y[None] + py - (offs[:, 1:2] + ky // 2)
    tx = x[None] + px - (offs[:, 2:] + kx // 2)
    ok = (tz % sz == 0) & (ty % sy == 0) & (tx % sx == 0) & fine_mask[None]
    oz, oy, ox = tz // sz, ty // sy, tx // sx
    ok = ok & (oz >= 0) & (oz < ngz) & (oy >= 0) & (oy < ngy) & \
        (ox >= 0) & (ox < ngx)
    return _lookup(coarse_keys, coarse_mask,
                   flatten_key(oz, oy, ox, coarse_grid), ok)


def sparse_to_dense(keys, vmask, feats, grid):
    """The active (V, C) features scattered onto the dense (Nz, Ny, Nx, C)
    grid (0 elsewhere)."""
    nz, ny, nx = grid
    c = feats.shape[-1]
    n = nz * ny * nx
    tgt = torch.where(vmask, keys, torch.full_like(keys, n))
    dense = feats.new_zeros((n + 1, c))
    dense = dense.index_copy(0, tgt, torch.where(
        vmask[:, None], feats, torch.zeros((), dtype=feats.dtype,
                                           device=feats.device)))
    return dense[:-1].reshape(nz, ny, nx, c)
