"""PNG reader for the KITTI images, in zlib and numpy only.

The port's replacement for `cv2.imread(path)` (IMREAD_COLOR) as
`dfm_tpu/data/pipeline.py:293-303` uses it: `read_png` returns the image
as (H, W, 3) uint8 in BGR order, the bytes cv2 returns, or None for a
missing or unreadable file (a prev frame that is absent makes the
pipeline use the current frame). It reads 8-bit non-interlaced PNGs of
colour types 0 (grey, copied to three channels), 2 (RGB) and 6 (RGBA,
alpha dropped), and raises ValueError on any other PNG (palette,
grey + alpha, 16 bits, interlaced).

Each row of a PNG is stored after one of five filters, which a writer
(libpng's adaptive choice, as KITTI's files and cv2 use it) picks per
row: None, Sub (left), Up (above), Average (left and above) and Paeth
(left, above, above-left). Sub, Average and Paeth make a byte depend
on its left neighbour once decoded, so no row of them can be undone in
one numpy expression. `unfilter` undoes all rows at once along
anti-diagonals: pixel (r, x) needs only pixels (r, x-1), (r-1, x) and
(r-1, x-1), which lie on the previous two diagonals r + x - 1 and
r + x - 2, so each of the H + W - 1 diagonals is one vectorised step
over up to H pixels, whatever filter each row uses.
"""

import struct
import zlib

import numpy as np

__all__ = ['read_png', 'png_shape', 'unfilter']

SIGNATURE = b'\x89PNG\r\n\x1a\n'
CHANNELS = {0: 1, 2: 3, 6: 4}      # colour type -> bytes per pixel


class _Unreadable(Exception):
    pass


def _chunks(data):
    """(IHDR fields, the concatenated IDAT bytes) of a PNG file's bytes;
    raises _Unreadable on a bad signature, a truncated chunk or a CRC
    that does not match."""
    if not data.startswith(SIGNATURE):
        raise _Unreadable('not a PNG')
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 12 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or \
                zlib.crc32(kind + body) != struct.unpack('>I', crc)[0]:
            raise _Unreadable('truncated or corrupt chunk')
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
        pos += 12 + length
    if header is None or not idat:
        raise _Unreadable('no IHDR or no IDAT')
    return header, b''.join(idat)


def unfilter(rows, filters, bpp):
    """Undo the PNG row filters.

    Args:
        rows: (H, W * bpp) uint8, the filtered bytes of each row (the
            filter byte taken off).
        filters: (H,) the filter type of each row, 0-4.
        bpp: bytes per pixel.

    Returns:
        (H, W * bpp) uint8, the image bytes.
    """
    h, stride = rows.shape
    w = stride // bpp
    r_idx = np.arange(h)[:, None]
    diag = r_idx + np.arange(w)[None, :]               # r + x
    # skewed layouts, one diagonal t = r + x per row: fk[t, r] is the
    # filtered pixel (r, t - r); sk[t + 1, r + 1] the decoded one, with a
    # zero row above the image (r = -1) and a zero pixel left of it
    # (x = -1) at sk[r, r + 1]
    fk = np.zeros((h + w - 1, h, bpp), np.int16)
    fk[diag, r_idx] = rows.reshape(h, w, bpp)
    sk = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    kind = np.asarray(filters, np.intp)[:, None]
    for t in range(h + w - 1):
        r0, r1 = max(0, t - w + 1), min(h - 1, t) + 1
        a = sk[t, r0 + 1:r1 + 1]            # left:       (r, x - 1)
        b = sk[t, r0:r1]                    # above:      (r - 1, x)
        c = sk[t - 1, r0:r1]                # above left: (r - 1, x - 1)
        ab = a + b
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(ab - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(kind[r0:r1], (0, a, b, ab >> 1, paeth))
        sk[t + 1, r0 + 1:r1 + 1] = (fk[t, r0:r1] + pred) & 0xFF
    out = sk[diag + 1, r_idx + 1]                     # (H, W, bpp)
    return out.astype(np.uint8).reshape(h, stride)


def png_shape(path):
    """(H, W, 3) of the PNG at `path` from its IHDR chunk (the shape
    `cv2.imread(path)` gives), without decoding it; ValueError for a file
    that does not start with a PNG header."""
    with open(path, 'rb') as f:
        head = f.read(24)
    if len(head) < 24 or not head.startswith(SIGNATURE) or \
            head[12:16] != b'IHDR':
        raise ValueError(f'{path}: no PNG header')
    width, height = struct.unpack('>II', head[16:24])
    return (height, width, 3)


def read_png(path):
    """The image at `path` as (H, W, 3) uint8 BGR, as `cv2.imread(path)`
    returns it; None if the file is missing or unreadable (not a PNG,
    truncated, corrupt). Raises ValueError for a PNG of a kind it does
    not read."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
        (width, height, depth, ctype, method, filt, interlace), idat = \
            _chunks(data)
    except (OSError, _Unreadable):
        return None
    if depth != 8 or ctype not in CHANNELS or interlace or method or filt:
        raise ValueError(
            f'{path}: PNG of bit depth {depth}, colour type {ctype}, '
            f'interlace {interlace}; read_png reads 8-bit non-interlaced '
            'grey (0), RGB (2) and RGBA (6) images')
    bpp = CHANNELS[ctype]
    try:
        raw = zlib.decompress(idat)
    except zlib.error:
        return None
    if len(raw) != height * (width * bpp + 1):
        return None
    rows = np.frombuffer(raw, np.uint8).reshape(height, width * bpp + 1)
    if (rows[:, 0] > 4).any():
        return None
    img = unfilter(rows[:, 1:], rows[:, 0], bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])
