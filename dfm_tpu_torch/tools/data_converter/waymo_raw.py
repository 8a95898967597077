"""Waymo TFRecord Frame parser (protobuf wire format), no devkit.

The port's own copy of `tools/data_converter/waymo_raw.py:36-182`
(`read_tfrecord`, `fields`, `parse_frame`, `camera_projection`): numpy
and struct only. Field numbers of the Frame protos read here:

  Frame:   context=1, timestamp_micros=2, pose=3, images=4, laser_labels=6
  Context: name=1, camera_calibrations=2 (name=1, intrinsic=2,
           extrinsic=3, width=4, height=5)
  Label:   box=1 (center_x/y/z=1/2/3, width=4, length=5, height=6,
           heading=7), type=3, id=4, num_lidar_points_in_box=7,
           most_visible_camera_name=11, camera_synced_box=12
  CameraImage: name=1, image=2

`parse_frame` gives the JAX parser's dict; each label also carries
'most_visible_camera' (str, '' where the record has none) and
'camera_synced_box' (a box dict, None where the record has none), which
the JAX parser skips and the port's converter reads
(`waymo_converter.py`).
"""

import struct

import numpy as np

__all__ = ['read_tfrecord', 'fields', 'parse_frame', 'camera_projection',
           'BOX_FIELDS', 'TYPE_NAMES']

# waymo label.proto Box field ids
BOX_FIELDS = {1: 'center_x', 2: 'center_y', 3: 'center_z',
              4: 'width', 5: 'length', 6: 'height', 7: 'heading'}
TYPE_NAMES = {0: 'Unknown', 1: 'Car', 2: 'Pedestrian', 3: 'Sign',
              4: 'Cyclist'}


def _varint(buf, i):
    x = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << s
        if not b & 0x80:
            return x, i
        s += 7


def fields(buf):
    """Yield (field number, wire type, value) of one message: an int for
    varints, the bytes of the field otherwise."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f'wire type {wt}')
        yield fn, wt, v


def _doubles(buf):
    """A message of tagged 64-bit doubles or of packed ones -> {field:
    [values]}."""
    out = {}
    for fn, wt, v in fields(buf):
        if wt == 1:
            out.setdefault(fn, []).append(struct.unpack('<d', v)[0])
        elif wt == 2 and len(v) % 8 == 0:
            out.setdefault(fn, []).extend(
                struct.unpack(f'<{len(v) // 8}d', v))
    return out


def read_tfrecord(path):
    """Yield the records of a TFRecord file (u64 length, u32 crc, data,
    u32 crc; the crcs are not checked)."""
    with open(path, 'rb') as f:
        buf = f.read()
    i = 0
    while i < len(buf):
        n = struct.unpack('<Q', buf[i:i + 8])[0]
        i += 12
        yield buf[i:i + n]
        i += n + 4


def _transform(buf):
    """Transform proto: repeated double transform=1 (16, row-major)."""
    d = _doubles(buf)
    m = np.asarray(d.get(1, np.eye(4).reshape(-1)), np.float64)
    return m.reshape(4, 4)


def _camera_calibration(buf):
    out = dict(name=0, intrinsic=None, extrinsic=np.eye(4),
               width=0, height=0)
    intr = []
    for fn, wt, v in fields(buf):
        if fn == 1 and wt == 0:
            out['name'] = v
        elif fn == 2 and wt == 1:      # repeated unpacked doubles
            intr.append(struct.unpack('<d', v)[0])
        elif fn == 2 and wt == 2:      # packed
            intr.extend(struct.unpack(f'<{len(v) // 8}d', v))
        elif fn == 3:
            out['extrinsic'] = _transform(v)
        elif fn == 4 and wt == 0:
            out['width'] = v
        elif fn == 5 and wt == 0:
            out['height'] = v
    out['intrinsic'] = np.asarray(intr)
    return out


def _box(buf):
    return {BOX_FIELDS[k]: vv[0] for k, vv in _doubles(buf).items()
            if k in BOX_FIELDS}


def _label(buf):
    out = dict(box=None, type=0, id='', num_points=0,
               most_visible_camera='', camera_synced_box=None)
    for fn, wt, v in fields(buf):
        if fn == 1:
            out['box'] = _box(v)
        elif fn == 3 and wt == 0:
            out['type'] = v
        elif fn == 4:
            out['id'] = v.decode('utf-8', 'replace')
        elif fn == 7 and wt == 0:
            out['num_points'] = v
        elif fn == 11 and wt == 2:
            out['most_visible_camera'] = v.decode('utf-8', 'replace')
        elif fn == 12 and wt == 2:
            out['camera_synced_box'] = _box(v)
    return out


def parse_frame(rec):
    """Raw Frame bytes -> dict(context_name, timestamp, pose, cameras
    [{name, intrinsic, extrinsic, width, height}], labels [{box, type, id,
    num_points, most_visible_camera, camera_synced_box}], images
    {camera name: bytes})."""
    out = dict(context_name='', timestamp=0, pose=np.eye(4),
               cameras=[], labels=[], images={})
    for fn, wt, v in fields(rec):
        if fn == 1:
            for cf, cw, cv in fields(v):
                if cf == 1 and cw == 2:
                    out['context_name'] = cv.decode('utf-8', 'replace')
                elif cf == 2:
                    out['cameras'].append(_camera_calibration(cv))
        elif fn == 2 and wt == 0:
            out['timestamp'] = v
        elif fn == 3:
            out['pose'] = _transform(v)
        elif fn == 4:
            name, img = 0, b''
            for gf, gw, gv in fields(v):
                if gf == 1 and gw == 0:
                    name = gv
                elif gf == 2:
                    img = gv
            out['images'][name] = img
        elif fn == 6:
            out['labels'].append(_label(v))
    return out


def camera_projection(cal):
    """KITTI-style P (4, 4) and Tr_velo_to_cam (4, 4) of a camera
    calibration: P from the intrinsics (f_u, f_v, c_u, c_v); Tr the
    inverse of the camera's extrinsic (vehicle <- camera) followed by the
    fixed swap from Waymo's camera axes (x forward, y left, z up) to
    KITTI's (z forward, x right, y down)."""
    fu, fv, cu, cv = cal['intrinsic'][:4]
    p = np.eye(4)
    p[0, 0], p[1, 1], p[0, 2], p[1, 2] = fu, fv, cu, cv
    v2c_waymo = np.linalg.inv(cal['extrinsic'])
    axes = np.array([[0, -1, 0, 0], [0, 0, -1, 0],
                     [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)
    return p, axes @ v2c_waymo
