"""The port's KITTI data half (dfm_tpu_torch.data) against the JAX package.

* `png.read_png` against `cv2.imread`, bit for bit: RGB, RGBA and grey
  images written by cv2 at two compression levels (the files hold Sub,
  Up, Average and Paeth rows, which the test asserts), and the files of
  the port's own encoder (`data/png.py:png_bytes`), which cycles all
  five filters by row. A missing or corrupt file gives None, a PNG of a
  kind it does not read a ValueError.
* `parse_calib_file`, `parse_label_file`, `build_kitti_infos` and
  `infos_from_reference_pkl` against the JAX package's, field for
  field, on the synthetic KITTI tree of chip_smoke.py (KITTI's own P2
  with its translation column, two widths, two intrinsics, a frame
  without a prev image) in `tmp_path`.
* `KittiDataset(train=False).get_sample` against JAX's for every key
  (exactly: the same numpy on the same bytes), every frame of that tree
  plus one whose prev image is gone when the sample is read.
"""

import os
import pickle
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from dfm_tpu.data import kitti as JK
from dfm_tpu_torch.data import kitti as PK
from dfm_tpu_torch.data.png import png_bytes, read_png

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic KITTI tree)


def png_filters(path):
    """The filter type of every row of a PNG file."""
    data = open(path, 'rb').read()
    pos, idat, hdr = 8, b'', None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', data[pos + 8:pos + 8 + n])
        elif kind == b'IDAT':
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(hdr[1], -1)[:, 0]


def _image(rng, h, w, c):
    """Smooth bands, a noise band and a flat band: libpng's adaptive
    filtering picks Sub, Up, Average and Paeth rows on it."""
    y, x = np.mgrid[0:h, 0:w]
    img = ((np.sin(x / 17.0) * 60 + np.cos(y / 11.0) * 50 + x * 0.1)[..., None]
           + np.arange(c) * 20 + rng.normal(0, 3, (h, w, c)))
    img[h // 3:h // 2] = rng.integers(0, 256, (h // 2 - h // 3, w, c))
    img[:, :w // 5] = 128
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize('level', [1, 9])
@pytest.mark.parametrize('channels', [3, 4, 1], ids=['rgb', 'rgba', 'grey'])
def test_read_png_matches_cv2(tmp_path, channels, level):
    cv2 = pytest.importorskip('cv2')
    path = str(tmp_path / 'img.png')
    img = _image(np.random.default_rng(channels * 10 + level), 60, 200,
                 channels)
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert {1, 2, 3, 4} <= set(png_filters(path).tolist())
    got, want = read_png(path), cv2.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == (60, 200, 3)
    np.testing.assert_array_equal(got, want)


def test_read_png_all_five_filters_match_cv2(tmp_path):
    """The port's encoder (`data/png.py:png_bytes`): row r stored with
    filter r % 5."""
    cv2 = pytest.importorskip('cv2')
    img = _image(np.random.default_rng(5), 37, 123, 3)
    path = str(tmp_path / 'five.png')
    with open(path, 'wb') as f:
        f.write(png_bytes(img))
    assert set(png_filters(path).tolist()) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(read_png(path), cv2.imread(path))
    np.testing.assert_array_equal(read_png(path), img)


def _png(ihdr, rows):
    def chunk(tag, body):
        return struct.pack('>I', len(body)) + tag + body + \
            struct.pack('>I', zlib.crc32(tag + body))
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack('>IIBBBBB',
                                                             *ihdr))
            + chunk(b'IDAT', zlib.compress(rows)) + chunk(b'IEND', b''))


def test_read_png_missing_corrupt_and_unsupported(tmp_path):
    assert read_png(str(tmp_path / 'absent.png')) is None
    good = png_bytes(np.zeros((4, 5, 3), np.uint8))
    for name, data in (('text.png', b'not a png'),
                       ('cut.png', good[:len(good) - 20]),
                       ('crc.png', good[:40] + bytes([good[40] ^ 1])
                        + good[41:])):
        (tmp_path / name).write_bytes(data)
        assert read_png(str(tmp_path / name)) is None, name
    rows = bytes(3 * (1 + 2 * 4))
    for name, ihdr in (('grey_alpha.png', (4, 3, 8, 4, 0, 0, 0)),
                       ('deep.png', (2, 3, 16, 2, 0, 0, 0)),
                       ('laced.png', (4, 3, 8, 0, 0, 0, 1))):
        (tmp_path / name).write_bytes(_png(ihdr, rows))
        with pytest.raises(ValueError, match='read_png reads'):
            read_png(str(tmp_path / name))


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti'))
    ids = chip_smoke.write_kitti_tree(root)
    return root, ids


def _same(a, b, where):
    """Nested dicts / lists / arrays equal, exactly."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)) and not (
            a and isinstance(a[0], str)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{where}[{i}]')
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_parse_calib_and_label_match_jax(tree):
    root, ids = tree
    for i in ids:
        base = os.path.join(root, 'training')
        calib = os.path.join(base, 'calib', f'{i:06d}.txt')
        _same(PK.parse_calib_file(calib), JK.parse_calib_file(calib), 'calib')
        label = os.path.join(base, 'label_2', f'{i:06d}.txt')
        objs = PK.parse_label_file(label)
        assert [o['name'] for o in objs] == ['Car'] * 11 + [
            'Pedestrian', 'Pedestrian', 'Cyclist', 'Cyclist', 'Van',
            'DontCare']
        _same(objs, JK.parse_label_file(label), 'labels')
    p2 = PK.parse_calib_file(calib)['P2']
    assert p2[0, 3] != 0 and p2[1, 3] != 0 and p2[2, 3] != 0


def test_build_kitti_infos_matches_jax(tree):
    root, ids = tree
    got = PK.build_kitti_infos(root, ids)
    _same(got, JK.build_kitti_infos(root, ids), 'infos')
    assert [len(i['sweeps']) for i in got] == [1, 1, 0, 1]
    assert got[0]['annos']['names'] == ['Car'] * 11 + [
        'Pedestrian', 'Pedestrian', 'Cyclist', 'Cyclist', 'Car']
    assert 'DontCare' in got[0]['annos_eval']['name']


def _reference_pkl(root, ids, path):
    """An mmdet3d-format info pickle of the tree (image / point_cloud /
    calib / annos), as tools/data_converter writes it."""
    infos = []
    for i in ids:
        base = os.path.join(root, 'training')
        c = PK.parse_calib_file(os.path.join(base, 'calib', f'{i:06d}.txt'))
        objs = PK.parse_label_file(os.path.join(base, 'label_2',
                                                f'{i:06d}.txt'))
        infos.append(dict(
            image=dict(image_idx=i, image_path=f'training/image_2/{i:06d}.png'),
            point_cloud=dict(velodyne_path=f'training/velodyne/{i:06d}.bin'),
            calib=dict(P2=c['P2'], R0_rect=c['R0_rect'],
                       Tr_velo_to_cam=c['Tr_velo_to_cam']),
            annos=dict(
                name=np.array([o['name'] for o in objs]),
                truncated=np.array([o['truncated'] for o in objs]),
                occluded=np.array([o['occluded'] for o in objs]),
                alpha=np.array([o['alpha'] for o in objs]),
                bbox=np.stack([o['bbox2d'] for o in objs]),
                dimensions=np.stack([o['dims'] for o in objs]),
                location=np.stack([o['loc'] for o in objs]),
                rotation_y=np.array([o['yaw'] for o in objs]))))
    with open(path, 'wb') as f:
        pickle.dump(infos, f)


def test_infos_from_reference_pkl_matches_jax(tree, tmp_path):
    root, ids = tree
    path = str(tmp_path / 'ref.pkl')
    _reference_pkl(root, ids, path)
    got = PK.infos_from_reference_pkl(path)
    _same(got, JK.infos_from_reference_pkl(path), 'infos')
    assert len(got) == len(ids) and all(not i['sweeps'] for i in got)


@pytest.fixture(scope='module')
def datasets(tree, tmp_path_factory):
    """Both packages' datasets (train=False, the DfM crop) on the tree's
    infos, and the same with frame 3's prev image gone after the infos
    were built (the pipeline then pairs the frame with itself)."""
    root, ids = tree
    infos = PK.build_kitti_infos(root, ids)
    gone = str(tmp_path_factory.mktemp('gone'))
    chip_smoke.write_kitti_tree(gone, frames=chip_smoke.KITTI_FRAMES[3:])
    gone_infos = PK.build_kitti_infos(gone, [3])
    os.remove(os.path.join(gone, gone_infos[0]['sweeps'][0]['data_path']))
    kw = dict(train=False, pipeline_kwargs=dict(crop_size=(320, 1280)))
    return [(PK.KittiDataset(r, i, **kw), JK.KittiDataset(r, i, **kw))
            for r, i in ((root, infos), (gone, gone_infos))]


@pytest.mark.parametrize('which,idx', [(0, 0), (0, 1), (0, 2), (0, 3),
                                       (1, 0)],
                         ids=['375x1242', '370x1224', 'no-sweep',
                              '370x1224-b', 'prev-image-gone'])
def test_get_sample_matches_jax(datasets, which, idx):
    pytest.importorskip('cv2')
    port, ref = datasets[which]
    got = port.get_sample(idx, np.random.default_rng(0))
    want = ref.get_sample(idx, np.random.default_rng(0))
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k], k)
    assert got['img'].shape == (2, 320, 1280, 3)
    assert got['gt_mask'].sum() == 16 and (got['depth_img'] > 0).sum() > 100
    assert got['crop_offset'][1] > 0 and got['cam2img'][0, 3] != 0
    if which == 1 or idx == 2:
        np.testing.assert_array_equal(got['img'][0], got['img'][1])
