"""Write the JPEG fixtures of the port's JPEG reader, with cv2.

    python tests/data/jpeg/make_fixtures.py [OUT_DIR]

Each image is a seeded synthetic scene (smooth gradients, a few flat
rectangles, mild noise), encoded by `cv2.imencode` at the quality,
chroma sampling and restart interval in `FIXTURES`. Beside each small
JPEG goes the PNG of its `cv2.imdecode` output; for every JPEG,
`manifest.json` holds its shape and the sha256 of the decoded BGR bytes
(the 1600x900 image's PNG would be megabytes, so it has the digest
alone). OUT_DIR defaults to this script's folder; the tests re-run the
script into a temporary folder and compare.
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np

SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
# name: (height, width, quality, sampling, restart interval in MCUs, png)
FIXTURES = {
    'small_420': (61, 83, 90, '420', 0, True),
    'small_444': (47, 70, 50, '444', 0, True),
    'small_422_rst': (33, 57, 95, '422', 1, True),
    'nus_1600x900_420': (900, 1600, 90, '420', 0, False),
}


def scene(h, w, seed):
    """(h, w, 3) uint8 BGR: gradients, rectangles and noise, seeded."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x / w * 200 + 20, y / h * 180 + 40,
                    (x + y) / (h + w) * 150 + 60], -1)
    for _ in range(8):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + rng.integers(1, h // 3 + 2),
            x0:x0 + rng.integers(1, w // 3 + 2)] = rng.integers(0, 256, 3)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main(out_dir=None):
    out_dir = out_dir or os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out_dir, exist_ok=True)
    manifest = {}
    for i, (name, (h, w, q, samp, rst, png)) in enumerate(FIXTURES.items()):
        ok, buf = cv2.imencode('.jpg', scene(h, w, i), [
            cv2.IMWRITE_JPEG_QUALITY, q,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[samp],
            cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        assert ok
        with open(os.path.join(out_dir, name + '.jpg'), 'wb') as f:
            f.write(buf.tobytes())
        dec = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if png:
            cv2.imwrite(os.path.join(out_dir, name + '.png'), dec)
        manifest[name] = dict(shape=list(dec.shape), quality=q,
                              sampling=samp, restart_interval=rst,
                              png=png, sha256=hashlib.sha256(
                                  dec.tobytes()).hexdigest())
    with open(os.path.join(out_dir, 'manifest.json'), 'w') as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else None)
