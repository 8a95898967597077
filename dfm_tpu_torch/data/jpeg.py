"""Baseline-JPEG reader in Python and numpy, as `cv2.imread` decodes.

The port's replacement for `cv2.imread(path)` (IMREAD_COLOR) on JPEG
files (nuScenes' and Waymo's camera images): `read_jpeg` returns (H, W,
3) uint8 BGR, the bytes cv2 returns, or None for a missing or
unreadable file. It reads baseline sequential DCT files (SOF0, and SOF1
at 8 bits: Huffman-coded, 8-bit samples) of 1 or 3 components, with any
sampling factors, interleaved or one scan per component, and restart
intervals (DRI, RSTn). Progressive, lossless, hierarchical,
arithmetic-coded and 12-bit files raise ValueError naming the mode.
`read_image` reads a PNG or a JPEG by its first bytes.

cv2 decodes with libjpeg-turbo's defaults, and so does this reader:

* the `JDCT_ISLOW` integer IDCT (jidctint.c: 13 fraction bits, 2 extra
  bits between the passes, the output wrapped to 10 bits and clamped by
  the range-limit table);
* "fancy" upsampling of subsampled chroma (jdsample.c): h2v1 and h1v2
  take 3/4 of the nearer and 1/4 of the farther sample, h2v2 the
  triangle filter of 9/16, 3/16, 3/16, 1/16, each with its rounding
  bias, the edges replicated at the component's own (not the MCU's)
  width and height; box replication where the component is no more
  than 2 samples wide, and for other integral ratios;
* the fixed-point YCbCr -> RGB tables of jdcolor.c (16 fraction bits).

The entropy decode is serial: one Python loop over the scan's symbols,
each Huffman code looked up in a 16-bit table, over the scan's bytes
with the stuffed zeros removed. What follows runs once over all blocks
in numpy: dequantisation, the IDCT, the upsampling and the colour
conversion.
"""

import struct

import numpy as np

from .png import SIGNATURE as PNG_SIGNATURE
from .png import read_png

__all__ = ['read_jpeg', 'read_image', 'decode_jpeg']

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_MODES = {0xC2: 'progressive DCT', 0xC3: 'lossless',
              0xC5: 'differential sequential (hierarchical)',
              0xC6: 'differential progressive (hierarchical)',
              0xC7: 'differential lossless (hierarchical)',
              0xC9: 'arithmetic-coded sequential',
              0xCA: 'arithmetic-coded progressive',
              0xCB: 'arithmetic-coded lossless',
              0xCD: 'arithmetic-coded differential sequential',
              0xCE: 'arithmetic-coded differential progressive',
              0xCF: 'arithmetic-coded differential lossless'}

# jidctint.c's constants: FIX(x) = round(x * 2^13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


class _Corrupt(Exception):
    pass


def _huffman_lut(counts, symbols):
    """A 16-bit lookup table of a Huffman table (DHT's 16 code-length
    counts and its symbols): entry `peek` (the next 16 bits of the
    stream) holds symbol | code length << 8; 0 where no code matches."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise _Corrupt('bad Huffman table')
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = symbols[k] | length << 8
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _unstuff(data, pos):
    """The entropy-coded bytes from `pos` to the next marker other than
    RSTn, the stuffed 0x00 after each 0xFF removed -> (bytes, offsets in
    them where each restart interval after the first begins, position of
    the marker that ends the scan)."""
    out = bytearray()
    restarts = []
    n = len(data)
    while True:
        nxt = data.find(b'\xff', pos)
        if nxt < 0 or nxt + 1 >= n:
            raise _Corrupt('scan without end')
        out += data[pos:nxt]
        m = data[nxt + 1]
        if m == 0x00:
            out.append(0xFF)
            pos = nxt + 2
        elif 0xD0 <= m <= 0xD7:
            restarts.append(len(out))
            pos = nxt + 2
        elif m == 0xFF:                 # fill byte before a marker
            pos = nxt + 1
        else:
            return bytes(out), restarts, nxt


def _decode_scan(data, scan, comps, frame, tables, restart_interval):
    """Huffman-decode one scan into the components' coefficient arrays
    (`comps[c]['coef']`, (blocks_h, blocks_w, 64) int32 in zigzag
    order); returns the position of the marker after it."""
    buf, restarts, end = _unstuff(data, scan['pos'])
    # 32-bit big-endian windows at every byte: 16 bits are peeked at any
    # bit offset from the window of its byte
    padded = np.frombuffer(buf + b'\0' * 8, np.uint8).astype(np.uint32)
    win = ((padded[:-3] << 24) | (padded[1:-2] << 16) | (padded[2:-1] << 8)
           | padded[3:]).tolist()
    ids = scan['ids']
    if len(ids) == 1:
        c = comps[ids[0]]
        mcux = -(-c['width'] // 8)
        mcuy = -(-c['height'] // 8)
        layout = [(ids[0], 0, 0)]
    else:
        mcux, mcuy = frame['mcux'], frame['mcuy']
        layout = [(i, by, bx) for i in ids for by in range(comps[i]['v'])
                  for bx in range(comps[i]['h'])]
    n_mcu = mcux * mcuy
    luts = {i: (tables[0, scan['dc'][i]], tables[1, scan['ac'][i]])
            for i in ids}
    pred = {i: 0 for i in ids}
    idx_out, val_out = [], []
    append_i, append_v = idx_out.append, val_out.append
    p = 0
    interval = restart_interval or n_mcu
    restart_pos = iter(restarts)
    for m in range(n_mcu):
        if m and m % interval == 0:
            off = next(restart_pos, None)
            if off is None:
                raise _Corrupt('missing restart marker')
            p = off * 8
            pred = dict.fromkeys(pred, 0)
        my, mx = divmod(m, mcux)
        for cid, by, bx in layout:
            c = comps[cid]
            if len(ids) == 1:
                row, col = my, mx
            else:
                row, col = my * c['v'] + by, mx * c['h'] + bx
            base = (row * c['bw'] + col) * 64 + c['offset']
            dc_lut, ac_lut = luts[cid]
            # DC: the category, then that many bits of difference
            w = win[p >> 3]
            code = dc_lut[(w >> (16 - (p & 7))) & 0xFFFF]
            if not code:
                raise _Corrupt('bad DC code')
            p += code >> 8
            s = code & 0xFF
            if s:
                v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pred[cid] += v
            if pred[cid]:
                append_i(base)
                append_v(pred[cid])
            k = 1
            while k < 64:
                w = win[p >> 3]
                code = ac_lut[(w >> (16 - (p & 7))) & 0xFFFF]
                if not code:
                    raise _Corrupt('bad AC code')
                p += code >> 8
                rs = code & 0xFF
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise _Corrupt('AC index past 63')
                    v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    append_i(base + k)
                    append_v(v)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
        if p > len(buf) * 8 + 64:
            raise _Corrupt('scan data ended early')
    for cid in ids:
        comps[cid]['_scans'] += 1
    if idx_out:
        flat = frame['coef']
        flat[np.asarray(idx_out, np.int64)] = np.asarray(val_out, np.int32)
    return end


def _idct_islow(coef):
    """jidctint.c's `jpeg_idct_islow` on (N, 64) dequantised coefficients
    in natural order -> (N, 8, 8) samples 0..255 (int64 arithmetic, the
    same shifts; the row pass's rounding is added to the DC term, as the
    C code does)."""
    x = coef.reshape(-1, 8, 8).astype(np.int64)

    def one_pass(d, shift, dc_bias):
        # d[..., k] is the k-th input along the transformed axis
        z2, z3 = d[..., 2], d[..., 6]
        z1 = (z2 + z3) * FIX_0_541196100
        tmp2 = z1 - z3 * FIX_1_847759065
        tmp3 = z1 + z2 * FIX_0_765366865
        z2, z3 = d[..., 0] + dc_bias, d[..., 4]
        tmp0 = (z2 + z3) << CONST_BITS
        tmp1 = (z2 - z3) << CONST_BITS
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * FIX_1_175875602
        t0 = t0 * FIX_0_298631336
        t1 = t1 * FIX_2_053119869
        t2 = t2 * FIX_3_072711026
        t3 = t3 * FIX_1_501321110
        z1 = z1 * -FIX_0_899976223
        z2 = z2 * -FIX_2_562915447
        z3 = z3 * -FIX_1_961570560 + z5
        z4 = z4 * -FIX_0_390180644 + z5
        t0 += z1 + z3
        t1 += z2 + z4
        t2 += z2 + z3
        t3 += z1 + z4
        out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], -1)
        return out >> shift

    # pass 1 over the columns (inputs along rows of the block), rounded
    cols = one_pass(np.swapaxes(x, 1, 2), 0, 0)
    cols = (cols + (1 << (CONST_BITS - PASS1_BITS - 1))) >> (
        CONST_BITS - PASS1_BITS)
    ws = np.swapaxes(cols, 1, 2)                    # ws[n, row, col]
    # pass 2 over the rows, the final rounding folded into the DC term
    out = one_pass(ws, CONST_BITS + PASS1_BITS + 3, 1 << (PASS1_BITS + 2))
    # range limit: wrap to 10 bits, add the centre, clamp
    out = ((out + 512) & 1023) - 512 + 128
    return np.clip(out, 0, 255)


def _h2v1(p):
    """jdsample.c `h2v1_fancy_upsample` of (h, w) samples -> (h, 2w)."""
    left = np.concatenate([p[:, :1], p[:, :-1]], 1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def _h1v2(p):
    """`h1v2_fancy_upsample`: (h, w) -> (2h, w)."""
    up = np.concatenate([p[:1], p[:-1]], 0)
    down = np.concatenate([p[1:], p[-1:]], 0)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    out[0::2] = (3 * p + up + 1) >> 2
    out[1::2] = (3 * p + down + 2) >> 2
    return out


def _h2v2(p):
    """`h2v2_fancy_upsample`: vertical 3:1 column sums with the row above
    (even output rows) or below (odd), then horizontal 3:1 with the
    biases 8 and 7 over 16 -> (2h, 2w)."""
    up = np.concatenate([p[:1], p[:-1]], 0)
    down = np.concatenate([p[1:], p[-1:]], 0)
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int64)
    for r, far in ((0, up), (1, down)):
        cs = 3 * p + far
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        out[r::2, 0::2] = (3 * cs + left + 8) >> 4
        out[r::2, 1::2] = (3 * cs + right + 7) >> 4
    return out


def _upsample(plane, hr, vr):
    """A component plane (its own width and height) to the full sampling
    grid, as libjpeg-turbo's default upsampler picks its method."""
    fancy_w = plane.shape[1] > 2
    if (hr, vr) == (1, 1):
        return plane
    if (hr, vr) == (2, 1) and fancy_w:
        return _h2v1(plane)
    if (hr, vr) == (1, 2):
        return _h1v2(plane)
    if (hr, vr) == (2, 2) and fancy_w:
        return _h2v2(plane)
    return np.repeat(np.repeat(plane, vr, 0), hr, 1)


def _ycc_to_bgr(y, cb, cr):
    """jdcolor.c `ycc_rgb_convert` with its 16-bit fixed-point tables."""
    one_half = 1 << 15

    def fix(x):
        return int(x * (1 << 16) + 0.5)

    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def _read_dht(body, tables):
    i = 0
    while i < len(body):
        tc, th = body[i] >> 4, body[i] & 15
        counts = body[i + 1:i + 17]
        n_sym = sum(counts)
        tables[tc, th] = _huffman_lut(counts, body[i + 17:i + 17 + n_sym])
        i += 17 + n_sym


def _read_dqt(body, qt):
    i = 0
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        if pq:
            vals = struct.unpack('>64H', body[i + 1:i + 129])
            i += 129
        else:
            vals = tuple(body[i + 1:i + 65])
            i += 65
        q = np.zeros(64, np.int64)
        q[ZIGZAG] = vals
        qt[tq] = q


def _read_sof(body):
    """SOF0 / SOF1 -> (frame dict, components by id, their order)."""
    prec, h, w, nc = struct.unpack('>BHHB', body[:6])
    if prec != 8:
        raise ValueError(f'JPEG of {prec}-bit samples is not read: 8-bit '
                         'only')
    if nc not in (1, 3):
        raise ValueError(f'JPEG of {nc} components is not read: 1 or 3 '
                         'only')
    if h == 0:
        raise ValueError('JPEG with its height in a DNL marker is not read')
    comps, order = {}, []
    for k in range(nc):
        cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
        if not (hv >> 4 and hv & 15):
            raise _Corrupt('zero sampling factor')
        comps[cid] = dict(h=hv >> 4, v=hv & 15, tq=tq, _scans=0)
        order.append(cid)
    hmax = max(c['h'] for c in comps.values())
    vmax = max(c['v'] for c in comps.values())
    frame = dict(h=h, w=w, hmax=hmax, vmax=vmax,
                 mcux=-(-w // (8 * hmax)), mcuy=-(-h // (8 * vmax)))
    offset = 0
    for cid in order:
        c = comps[cid]
        c['width'] = -(-w * c['h'] // hmax)
        c['height'] = -(-h * c['v'] // vmax)
        c['bw'] = frame['mcux'] * c['h']
        c['bh'] = frame['mcuy'] * c['v']
        c['offset'] = offset
        offset += c['bw'] * c['bh'] * 64
    frame['coef'] = np.zeros(offset, np.int32)
    return frame, comps, order


def decode_jpeg(data):
    """The bytes of a JPEG file -> (H, W, 3) uint8 BGR. Raises ValueError
    for a mode it does not read, `_Corrupt` for a damaged file."""
    if data[:2] != b'\xff\xd8':
        raise _Corrupt('no SOI')
    qt, tables = {}, {}
    frame = comps = order = None
    restart_interval = 0
    adobe_transform = None
    pos, n = 2, len(data)
    while True:
        if pos >= n or data[pos] != 0xFF:
            raise _Corrupt('marker expected')
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise _Corrupt('truncated')
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        length = struct.unpack('>H', data[pos:pos + 2])[0]
        body = data[pos + 2:pos + length]
        pos += length
        if m in _SOF_MODES:
            raise ValueError(f'JPEG mode {_SOF_MODES[m]} (SOF{m - 0xC0}) '
                             'is not read: baseline sequential DCT only')
        if m == 0xCC:
            raise ValueError('JPEG mode arithmetic coding (DAC) is not '
                             'read: baseline sequential DCT only')
        if m == 0xDB:
            _read_dqt(body, qt)
        elif m == 0xC4:
            _read_dht(body, tables)
        elif m == 0xDD:
            restart_interval = struct.unpack('>H', body[:2])[0]
        elif m == 0xEE and body[:5] == b'Adobe' and len(body) >= 12:
            adobe_transform = body[11]
        elif m in (0xC0, 0xC1):
            frame, comps, order = _read_sof(body)
        elif m == 0xDA:
            if frame is None:
                raise _Corrupt('SOS before SOF')
            scan = dict(ids=[], dc={}, ac={}, pos=pos)
            for k in range(body[0]):
                cid, t = body[1 + 2 * k:3 + 2 * k]
                if cid not in comps or (0, t >> 4) not in tables or \
                        (1, t & 15) not in tables:
                    raise _Corrupt('scan of an unknown component or table')
                scan['ids'].append(cid)
                scan['dc'][cid], scan['ac'][cid] = t >> 4, t & 15
            pos = _decode_scan(data, scan, comps, frame, tables,
                               restart_interval)
    if frame is None:
        raise _Corrupt('no frame')
    return _image(qt, frame, comps, order, adobe_transform)


def _image(qt, frame, comps, order, adobe_transform):
    planes = []
    for cid in order:
        c = comps[cid]
        if not c['_scans']:
            raise _Corrupt('a component without a scan')
        if c['tq'] not in qt:
            raise _Corrupt('missing quantisation table')
        coef = frame['coef'][c['offset']:c['offset'] + c['bw'] * c['bh']
                             * 64].reshape(-1, 64)
        nat = np.empty_like(coef, np.int64)
        nat[:, ZIGZAG] = coef
        blocks = _idct_islow(nat * qt[c['tq']])
        plane = blocks.reshape(c['bh'], c['bw'], 8, 8).transpose(
            0, 2, 1, 3).reshape(c['bh'] * 8, c['bw'] * 8)
        plane = plane[:c['height'], :c['width']]
        full = _upsample(plane, frame['hmax'] // c['h'],
                         frame['vmax'] // c['v'])
        planes.append(full[:frame['h'], :frame['w']])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, 2)
    rgb_ids = tuple(order) == (82, 71, 66)
    if adobe_transform == 0 or (adobe_transform is None and rgb_ids):
        return np.stack(planes[::-1], -1).astype(np.uint8)
    return _ycc_to_bgr(*planes)


def read_jpeg(path):
    """The JPEG image at `path` as (H, W, 3) uint8 BGR, as
    `cv2.imread(path)` returns it; None if the file is missing or
    unreadable (not a JPEG, truncated, corrupt). Raises ValueError for a
    JPEG of a mode it does not read (progressive, lossless,
    hierarchical, arithmetic-coded, 12-bit)."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError:
        return None
    try:
        return decode_jpeg(data)
    except (_Corrupt, IndexError, struct.error, StopIteration):
        return None


def read_image(path):
    """A PNG (`read_png`) or a JPEG (`read_jpeg`) by its first bytes, as
    `cv2.imread(path)` reads either; None for a missing file or one of
    neither kind."""
    try:
        with open(path, 'rb') as f:
            head = f.read(8)
    except OSError:
        return None
    if head.startswith(PNG_SIGNATURE):
        return read_png(path)
    if head[:3] == b'\xff\xd8\xff':
        return read_jpeg(path)
    return None
