"""Build and load the hand-written CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes` (no PyTorch
headers: a build takes seconds). Libraries go to `build/kernels/` at
the repository root, named by a hash of their sources and flags, and
are built on first use; `build_all` starts one `nvcc` per source, all
at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ['SOURCES', 'build_all', 'load', 'build_log']

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# library -> (source, {C function: argtypes}); every function returns
# cudaGetLastError() after its launch
SOURCES = {
    'warp_prev': ('warp_prev.cu', {
        'dfm_warp_prev_sweep': [_P] * 4 + [_I] * 7 + [_F, _I, _P],
        'dfm_warp_prev_sweep_bwd': [_P] * 4 + [_I] * 7 + [_F, _I, _P]}),
    'frustum_sample': ('frustum_sample.cu', {
        'dfm_voxel_features': [_P] * 7 + [_I] * 11 + [_F, _F, _I, _P],
        'dfm_voxel_features_bwd': [_P] * 7 + [_I] * 11 + [_F, _F, _I, _P],
        'dfm_attention_sample': [_P] * 5 + [_I] * 7 + [_F, _F, _I, _P]}),
    'conv_chain': ('conv_chain.cu', {
        'dfm_pack_vol': [_P, _P, _I, _I, _I, _P],
        'dfm_unpack_vol': [_P, _P, _I, _I, _I, _P],
        'dfm_conv_p2p': [_P] * 4 + [_I] * 6 + [_P],
        'dfm_unpack_affine': [_P] * 5 + [_I] * 4 + [_P],
        'dfm_affine_chain': [_P] * 5 + [_I] * 4 + [_P]}),
    'hourglass_chain': ('hourglass_chain.cu', {
        'dfm_conv_s2': [_P] * 4 + [_I] * 5 + [_P],
        'dfm_pack_parity8': [_P] * 3 + [_I] * 3 + [_L] * 4 + [_P]}),
    'conv3d': ('conv3d.cu', {
        'dfm_conv3d_direct': [_P] * 4 + [_I] * 7 + [_P],
        'dfm_conv3d_wgmma': [_P] * 4 + [_I] * 8 + [_P],
        'dfm_conv3d_gn_finish': [_P] * 5 + [_L] + [_I] * 4 + [_P]}),
}

_LIBS = {}


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ((home and os.path.join(home, 'bin', 'nvcc')),
                 shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                       'are compiled on first use')


def _target(name):
    src = CSRC / SOURCES[name][0]
    h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob('*.cu*')):    # sources and shared headers
        h.update(f.read_bytes())
    return src, BUILD_DIR / f'{name}-{h.hexdigest()[:12]}.so'


def build_log(name):
    """nvcc's output (registers, spills) for a built library."""
    log = _target(name)[1].with_suffix('.log')
    return log.read_text() if log.exists() else ''


def build_all(names=None):
    """Compile the libraries not built yet, one nvcc per source, all
    started together. Returns the wall seconds spent."""
    names = list(SOURCES) if names is None else list(names)
    todo = [(n,) + _target(n) for n in names if not _target(n)[1].exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, src, lib in todo:
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
        procs.append((name, lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name}:\n{out}')
            continue
        lib.with_suffix('.log').write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return time.perf_counter() - t0


def load(name):
    """The ctypes library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        for fn, argtypes in SOURCES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
