"""The port's baseline-JPEG reader (`data/jpeg.py`) against cv2.imdecode.

Stated bound: on every image, the largest absolute difference from
`cv2.imdecode(buf, IMREAD_COLOR)` is at most 1 level and at least
99.9 % of the pixels are equal in all three channels. Measured here
(cv2 5.0.0, libjpeg-turbo 3.1.2): every image of this file and every
committed fixture decodes bit for bit (max difference 0, 100 % of the
pixels exact), the tests assert that too.

Images are encoded by the tests with `cv2.imencode` (qualities 50 and
95, odd sizes down to 1x1, 4:4:4 / 4:2:2 / 4:2:0 and 4:4:0 / 4:1:1,
restart intervals, a grey image); the fixtures under tests/data/jpeg/
come from its `make_fixtures.py`, which a test re-runs.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dfm_tpu_torch.data.jpeg import decode_jpeg, read_image, read_jpeg
from dfm_tpu_torch.data.png import read_png

torch.set_num_threads(1)    # from import on; the workers share the cores

cv2 = pytest.importorskip('cv2')

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, 'data', 'jpeg')
SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def scene(h, w, seed, noise=30.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / max(w, 1), y * 255 / max(h, 1),
                     (x + y) * 127 / (h + w)], -1)
    return np.clip(base + rng.normal(0, noise, (h, w, 3)), 0,
                   255).astype(np.uint8)


def encode(img, quality=90, sampling='420', rst=0, progressive=False):
    ok, buf = cv2.imencode('.jpg', img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return buf


def check_bound(got, want):
    """The stated bound, and the measured bit equality."""
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff.max(-1) == 0).mean() >= 0.999
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('sampling', ['444', '422', '420', '440', '411'])
@pytest.mark.parametrize('quality', [50, 95])
@pytest.mark.parametrize('hw', [(37, 53), (64, 96), (17, 9)])
def test_matches_cv2(hw, quality, sampling):
    buf = encode(scene(*hw, seed=hw[0] + quality), quality, sampling)
    check_bound(decode_jpeg(buf.tobytes()), cv2.imdecode(buf,
                                                         cv2.IMREAD_COLOR))


@pytest.mark.parametrize('sampling', ['444', '420'])
@pytest.mark.parametrize('rst', [1, 3])
def test_restart_markers(rst, sampling):
    buf = encode(scene(45, 71, rst), 80, sampling, rst=rst)
    assert b'\xff\xd0' in buf.tobytes()
    check_bound(decode_jpeg(buf.tobytes()), cv2.imdecode(buf,
                                                         cv2.IMREAD_COLOR))


@pytest.mark.parametrize('hw', [(1, 1), (2, 3), (3, 5), (8, 16)])
def test_tiny_images(hw):
    """Chroma no more than 2 samples wide is box-upsampled (libjpeg-turbo
    takes the fancy filters only above 2)."""
    buf = encode(scene(*hw, seed=1), 90, '420')
    check_bound(decode_jpeg(buf.tobytes()), cv2.imdecode(buf,
                                                         cv2.IMREAD_COLOR))


def test_grey_image():
    buf = cv2.imencode('.jpg', scene(40, 30, 2)[..., 0])[1]
    check_bound(decode_jpeg(buf.tobytes()), cv2.imdecode(buf,
                                                         cv2.IMREAD_COLOR))


def test_refusals():
    """Progressive, arithmetic-coded and 12-bit files raise ValueError
    naming the mode; a truncated or damaged file reads as None, as
    cv2.imread gives None."""
    img = scene(24, 32, 3)
    with pytest.raises(ValueError, match='progressive'):
        decode_jpeg(encode(img, progressive=True).tobytes())
    data = bytearray(encode(img).tobytes())
    sof = data.index(b'\xff\xc0')
    arith = bytearray(data)
    arith[sof + 1] = 0xC9
    with pytest.raises(ValueError, match='arithmetic'):
        decode_jpeg(bytes(arith))
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match='12-bit'):
        decode_jpeg(bytes(twelve))
    lossless = bytearray(data)
    lossless[sof + 1] = 0xC3
    with pytest.raises(ValueError, match='lossless'):
        decode_jpeg(bytes(lossless))


def test_read_by_magic_bytes(tmp_path):
    """`read_image` goes by the first bytes, not the extension; missing,
    truncated and foreign files give None."""
    img = scene(21, 34, 4)
    buf = encode(img, 90, '444')
    as_png = tmp_path / 'really_a_jpeg.png'
    as_png.write_bytes(buf.tobytes())
    want = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(read_image(str(as_png)), want)
    np.testing.assert_array_equal(read_jpeg(str(as_png)), want)
    as_jpg = tmp_path / 'really_a_png.jpg'
    as_jpg.write_bytes(cv2.imencode('.png', img)[1].tobytes())
    np.testing.assert_array_equal(read_image(str(as_jpg)), img)
    assert read_image(str(tmp_path / 'missing.jpg')) is None
    assert read_jpeg(str(tmp_path / 'missing.jpg')) is None
    cut = tmp_path / 'cut.jpg'
    cut.write_bytes(buf.tobytes()[:len(buf) // 2])
    assert read_jpeg(str(cut)) is None
    other = tmp_path / 'text.jpg'
    other.write_bytes(b'not an image at all')
    assert read_image(str(other)) is None and read_jpeg(str(other)) is None


def test_fixtures_rebuilt_and_decoded(tmp_path):
    """`make_fixtures.py` re-run gives the committed bytes; each committed
    JPEG decodes to its PNG (read by the port's PNG reader) and to the
    digest in the manifest."""
    out = tmp_path / 'jpeg'
    subprocess.run([sys.executable, os.path.join(FIXTURES,
                                                 'make_fixtures.py'),
                    str(out)], check=True, timeout=120)
    with open(os.path.join(FIXTURES, 'manifest.json')) as f:
        manifest = json.load(f)
    assert json.loads((out / 'manifest.json').read_text()) == manifest
    assert {m['sampling'] for m in manifest.values()} >= {'420', '444'}
    assert any(m['restart_interval'] for m in manifest.values())
    assert any(m['shape'] == [900, 1600, 3] for m in manifest.values())
    total = 0
    for name, m in manifest.items():
        exts = ('.jpg', '.png') if m['png'] else ('.jpg',)
        for ext in exts:
            path = os.path.join(FIXTURES, name + ext)
            assert (out / (name + ext)).read_bytes() == open(path,
                                                             'rb').read()
            total += os.path.getsize(path)
        got = read_jpeg(os.path.join(FIXTURES, name + '.jpg'))
        assert list(got.shape) == m['shape']
        assert hashlib.sha256(got.tobytes()).hexdigest() == m['sha256']
        if m['png']:
            check_bound(got, read_png(os.path.join(FIXTURES, name + '.png')))
    assert total < 1 << 20


def test_cv2_imread_of_fixture(tmp_path):
    """The reader on a file path equals cv2.imread of the same file."""
    src = os.path.join(FIXTURES, 'small_422_rst.jpg')
    path = tmp_path / 'x.jpg'
    shutil.copy(src, path)
    check_bound(read_jpeg(str(path)), cv2.imread(str(path)))
