"""Read a flax msgpack tree (`flax.serialization.msgpack_serialize`,
`msgpack_restore`) with the standard library and numpy.

The teacher checkpoints of DfMFull are such files
(`dfm_tpu/utils/checkpoint_import.py:load_msgpack_tree`). The decoder
takes msgpack's maps, arrays (as lists), str, bin, int, float, bool and
nil, and two of flax's ext types: 1, an ndarray (the msgpack of (shape,
dtype name, C-order bytes)), and 3, a numpy scalar (the same, 0-d). Any
other ext type is refused by its code. bfloat16 arrays are widened to
float32 exactly (numpy has no bfloat16). Flax's chunked arrays (a map
with '__msgpack_chunked_array__', 'shape' and 'chunks') are joined back.
"""

import struct

import numpy as np

__all__ = ['msgpack_loads', 'load_msgpack_tree']

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = '__msgpack_chunked_array__'


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError('msgpack data ends inside an object')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.unpack('B')
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return self.array(t & 0x0f)
        if 0xa0 <= t <= 0xbf:
            return self.str(t & 0x1f)
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in fixed:
            return fixed[t]
        sized = {0xc4: ('>B', 'bin'), 0xc5: ('>H', 'bin'), 0xc6: ('>I', 'bin'),
                 0xd9: ('>B', 'str'), 0xda: ('>H', 'str'), 0xdb: ('>I', 'str'),
                 0xdc: ('>H', 'array'), 0xdd: ('>I', 'array'),
                 0xde: ('>H', 'map'), 0xdf: ('>I', 'map'),
                 0xc7: ('>B', 'ext'), 0xc8: ('>H', 'ext'), 0xc9: ('>I', 'ext')}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == 'bin':
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H',
                   0xce: '>I', 0xcf: '>Q', 0xd0: '>b', 0xd1: '>h',
                   0xd2: '>i', 0xd3: '>q'}
        if t in numbers:
            return self.unpack(numbers[t])
        if 0xd4 <= t <= 0xd8:                    # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (t - 0xd4))
        raise ValueError(f'msgpack: byte 0x{t:02x} at offset {self.pos - 1} '
                         'starts no object')

    def str(self, n):
        return bytes(self.take(n)).decode('utf-8')

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n):
        code = self.unpack('b')
        body = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(body)
        if code == _EXT_NPSCALAR:
            return _ndarray(body)[()]
        raise ValueError(f'msgpack ext type {code} is not a flax ndarray '
                         f'({_EXT_NDARRAY}) or numpy scalar ({_EXT_NPSCALAR})')


def _ndarray(body):
    r = _Reader(body)
    shape, name, buf = r.obj()
    if r.pos != len(body):
        raise ValueError('msgpack ndarray: trailing bytes')
    if isinstance(name, bytes):
        name = name.decode('ascii')
    if name == 'bfloat16':
        bits = np.frombuffer(buf, dtype='<u2').astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name)).copy()
    return arr.reshape(tuple(shape))


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_loads(data):
    """The tree of one msgpack object in `data` (bytes)."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f'msgpack: {len(r.data) - r.pos} bytes after the '
                         'object')
    return _unchunk(tree)


def load_msgpack_tree(path):
    """The tree of the flax msgpack file at `path`."""
    with open(path, 'rb') as f:
        return msgpack_loads(f.read())
