"""Pure-Python LET-3D-AP (longitudinal error tolerant) Waymo metric.

Port of `dfm_tpu/evaluation/waymo_let.py`: the camera-only detection
metric of the official `compute_detection_let_metrics_main` binary
(reference datasets/waymo_dataset.py:636-706 shells out to it and
parses "[LET-mAPL x] [LET-mAP y] [LET-mAPH z]" per class), which stays
the source of truth where it is available (`evaluation/waymo_eval.py`).

Metric definition (Hung et al., "LET-3D-AP: Longitudinal Error
Tolerant 3D Average Precision for Camera-Only 3D Detection", 2022), with
the details the JAX package calibrated against the official binary:

  * Line of sight from the CAMERA at (1.43, 0, 2.18) in the vehicle
    frame. For GT centre g, camera s: u = (g-s)/|g-s|; prediction p:
    e_l = (p - g).u; tolerance T_l = max(pct * |g-s|, min_tol).
  * Longitudinal affinity a_l = 1 - |e_l|/T_l (0 outside tolerance).
  * LET-IoU: the prediction translated by -e_l u, then rotated-BEV-3D
    IoU against the GT box.
  * A pair is matchable if a_l > 0 and LET-IoU >= class threshold.
  * Bipartite matching per frame maximising the matched LET-IoU.
  * PR curve: one operating point per distinct score; points that do not
    increase recall are dropped (first kept); an implicit start point
    (0, p_first); recall gaps above delta=0.05 get a trapezoid ramp;
    AP = the area.
  * APH / APL: the same over precision weighted per TP by heading
    accuracy max(0, 1 - |dtheta_wrapped|/pi) / by a_l.

Config of the official camera-only challenge: tolerance pct 0.1, min
0.5 m, IoU thresholds Vehicle 0.5, Ped/Cyclist/Sign 0.3.

The one difference from the JAX package: the operating points are the
prediction scores as they are, and a prediction is kept at a cutoff when
its score is >= the cutoff, on the same values. The JAX package rounds
the cutoffs to 6 decimals (`dfm_tpu/evaluation/waymo_let.py:197`) and
keeps `score >= cutoff - 1e-9` (`:206`), while a score read back from a
.bin is a float32 (`dfm_tpu/evaluation/waymo_proto.py:119`): 0.9 reads
back as 0.8999999762, below its own rounded cutoff 0.9, so every score
that float32 does not hold exactly loses its operating point there.
"""

import numpy as np

__all__ = ['let_detection_metrics', 'LetConfig']


class LetConfig:
    tolerance_pct = 0.1
    tolerance_min = 0.5
    recall_delta = 0.05
    iou_thresholds = {1: 0.5, 2: 0.3, 3: 0.3, 4: 0.3}  # type id -> thr
    class_names = {1: 'Vehicle', 2: 'Pedestrian', 3: 'Sign', 4: 'Cyclist'}
    # sensor location in the vehicle frame (fitted; see module doc)
    camera_locations = {'': np.array([1.43, 0.0, 2.18])}

    @classmethod
    def camera_location(cls, name):
        return cls.camera_locations.get(name, cls.camera_locations[''])


def _box_corners_bev(cx, cy, length, width, heading):
    """(N,) params -> (N, 4, 2) BEV corners (x forward, y left)."""
    c, s = np.cos(heading), np.sin(heading)
    # counter-clockwise winding (the half-plane clipper assumes it)
    dx = np.stack([length / 2, length / 2, -length / 2, -length / 2], -1)
    dy = np.stack([-width / 2, width / 2, width / 2, -width / 2], -1)
    x = cx[..., None] + c[..., None] * dx - s[..., None] * dy
    y = cy[..., None] + s[..., None] * dx + c[..., None] * dy
    return np.stack([x, y], -1)


def _poly_area(poly):
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_poly(subject, cp1, cp2):
    """Sutherland-Hodgman: clip polygon by half-plane left of cp1->cp2."""
    def inside(p):
        return ((cp2[0] - cp1[0]) * (p[1] - cp1[1]) -
                (cp2[1] - cp1[1]) * (p[0] - cp1[0])) >= -1e-12

    def inter(a, b):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (a[0] - b[0], a[1] - b[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = a[0] * b[1] - a[1] * b[0]
        den = dc[0] * dp[1] - dc[1] * dp[0]
        if abs(den) < 1e-12:
            return b
        return ((n1 * dp[0] - n2 * dc[0]) / den,
                (n1 * dp[1] - n2 * dc[1]) / den)

    out = list(subject)
    if not out:
        return out
    result = []
    s = out[-1]
    for e in out:
        if inside(e):
            if not inside(s):
                result.append(inter(s, e))
            result.append(e)
        elif inside(s):
            result.append(inter(s, e))
        s = e
    return result


def _rotated_iou_3d(b1, b2):
    """IoU of two 7-dof boxes (cx, cy, cz, l, w, h, heading), z-up."""
    c1 = _box_corners_bev(np.array(b1[0]), np.array(b1[1]),
                          np.array(b1[3]), np.array(b1[4]),
                          np.array(b1[6]))
    c2 = _box_corners_bev(np.array(b2[0]), np.array(b2[1]),
                          np.array(b2[3]), np.array(b2[4]),
                          np.array(b2[6]))
    poly = [tuple(p) for p in c1]
    clip = [tuple(p) for p in c2]
    for i in range(4):
        poly = _clip_poly(poly, clip[i], clip[(i + 1) % 4])
        if not poly:
            break
    inter_bev = _poly_area(np.array(poly)) if len(poly) >= 3 else 0.0
    z1a, z1b = b1[2] - b1[5] / 2, b1[2] + b1[5] / 2
    z2a, z2b = b2[2] - b2[5] / 2, b2[2] + b2[5] / 2
    inter_z = max(0.0, min(z1b, z2b) - max(z1a, z2a))
    inter = inter_bev * inter_z
    vol1 = b1[3] * b1[4] * b1[5]
    vol2 = b2[3] * b2[4] * b2[5]
    union = vol1 + vol2 - inter
    return inter / union if union > 0 else 0.0


def _box7(o, synced=False):
    b = o.camera_synced_box if (synced and o.camera_synced_box is not None) \
        else o.box
    return np.array([b.center_x, b.center_y, b.center_z,
                     b.length, b.width, b.height, b.heading])


def _greedy_match(iou_mat, qual=None):
    """Maximize total matched IoU (Hungarian, like the official
    TYPE_HUNGARIAN matcher); returns list of (pi, gi)."""
    if iou_mat.size == 0:
        return []
    try:
        from scipy.optimize import linear_sum_assignment
        pis, gis = linear_sum_assignment(-iou_mat)
        return [(int(p), int(g)) for p, g in zip(pis, gis)
                if iou_mat[p, g] > 0]
    except ImportError:
        pairs = []
        used_p, used_g = set(), set()
        order = np.dstack(np.unravel_index(
            np.argsort(-iou_mat, axis=None), iou_mat.shape))[0]
        for pi, gi in order:
            if iou_mat[pi, gi] <= 0:
                break
            if pi in used_p or gi in used_g:
                continue
            pairs.append((int(pi), int(gi)))
            used_p.add(pi)
            used_g.add(gi)
        return pairs


def let_detection_metrics(preds, gts, cfg=LetConfig):
    """Compute LET-mAPL / LET-mAP / LET-mAPH per class.

    Args:
        preds / gts: lists of `waymo_proto.ObjectPred`. GT entries use
            `camera_synced_box` when present (matching the official
            binary, which drops GT without `most_visible_camera_name`).

    Returns:
        {'<Class> mAPL': float, '<Class> mAP': ..., '<Class> mAPH': ...,
         'Overall ...': mean over Vehicle/Pedestrian/Cyclist}.
    """
    out = {}
    for cls_id, cls_name in cfg.class_names.items():
        thr = cfg.iou_thresholds[cls_id]
        cls_preds = [o for o in preds if o.type == cls_id]
        cls_gts = [o for o in gts if o.type == cls_id
                   and o.most_visible_camera_name != '']
        frames = {}
        for o in cls_preds:
            frames.setdefault(
                (o.context_name, o.frame_timestamp_micros),
                ([], []))[0].append(o)
        for o in cls_gts:
            frames.setdefault(
                (o.context_name, o.frame_timestamp_micros),
                ([], []))[1].append(o)

        num_gt = len(cls_gts)
        # the scores as they are (decoded float32 from a .bin): every
        # prediction is kept at its own cutoff
        scores = sorted({float(o.score) for o in cls_preds}, reverse=True)
        curve = []     # (recall, precision, precision_h, precision_l)
        for cutoff in scores:
            tp = 0.0
            tp_h = 0.0
            tp_l = 0.0
            n_kept = 0
            for (ps, gs) in frames.values():
                kept = [o for o in ps if float(o.score) >= cutoff]
                n_kept += len(kept)
                if not kept or not gs:
                    continue
                iou = np.zeros((len(kept), len(gs)))
                aff = np.zeros_like(iou)
                hacc = np.zeros_like(iou)
                for gi, g in enumerate(gs):
                    gb = _box7(g, synced=True)
                    cam = cfg.camera_location(g.most_visible_camera_name)
                    los = gb[:3] - cam
                    rng = float(np.linalg.norm(los))
                    tol = max(cfg.tolerance_pct * rng, cfg.tolerance_min)
                    u = los / max(rng, 1e-9)
                    for pi, p in enumerate(kept):
                        pb = _box7(p)
                        e_l = float(np.dot(pb[:3] - gb[:3], u))
                        if abs(e_l) > tol:
                            continue
                        aligned = pb.copy()
                        aligned[:3] = pb[:3] - e_l * u
                        v = _rotated_iou_3d(aligned, gb)
                        if v < thr:
                            continue
                        iou[pi, gi] = v
                        aff[pi, gi] = 1.0 - abs(e_l) / tol
                        dth = abs((pb[6] - gb[6] + np.pi) %
                                  (2 * np.pi) - np.pi)
                        hacc[pi, gi] = max(0.0, 1.0 - dth / np.pi)
                for pi, gi in _greedy_match(iou, None):
                    tp += 1.0
                    tp_h += hacc[pi, gi]
                    tp_l += aff[pi, gi]
            fp = n_kept - tp
            denom = tp + fp
            recall = tp / num_gt if num_gt else 0.0
            curve.append((recall,
                          tp / denom if denom else 0.0,
                          tp_h / denom if denom else 0.0,
                          tp_l / denom if denom else 0.0))

        def integrate(col):
            # calibrated against the official binary (see module doc):
            # drop points that do not increase recall (first kept);
            # flat precision per segment = suffix-max envelope of the
            # segment-end precision; a trapezoid ramp of width
            # min(delta, dr) from the previous point's ORIGINAL
            # precision to the envelope value; implicit start (0, p0)
            pts = []
            prev_r = -1.0
            for (r, *ps) in curve:
                if r > prev_r:
                    pts.append([r, ps[col]])
                    prev_r = r
            if not pts:
                return 0.0
            env = [p for _, p in pts]
            for i in range(len(env) - 2, -1, -1):
                env[i] = max(env[i], env[i + 1])
            delta = cfg.recall_delta
            ap = 0.0
            r0, p0 = 0.0, pts[0][1]
            for (r1, p1), pe in zip(pts, env):
                dr = r1 - r0
                if dr > 0:
                    ramp = min(delta, dr)
                    ap += ramp * (p0 + pe) / 2 + (dr - ramp) * pe
                r0, p0 = r1, p1
            return ap
        out[f'{cls_name} mAPL'] = integrate(2)
        out[f'{cls_name} mAP'] = integrate(0)
        out[f'{cls_name} mAPH'] = integrate(1)
    for suffix in ('mAPL', 'mAP', 'mAPH'):
        out[f'Overall {suffix}'] = (
            out[f'Vehicle {suffix}'] + out[f'Pedestrian {suffix}'] +
            out[f'Cyclist {suffix}']) / 3
    return out
