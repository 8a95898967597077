"""Where K5's time goes on the card, and the swizzle its A operand relies on.

    python -m dfm_tpu_torch.probe_k5 [--reps 30]

Needs a CUDA card and `nvcc`. Two measurements, one JSON line each:

1. `swizzle`: a one-block kernel loads a 96 x 64-byte matrix with TMA's
   64-byte swizzle and reads it back through `wgmma` with a 64-byte-
   swizzle K-major descriptor (`csrc/wgmma.cuh:desc_hi_sw64`) whose start
   lies at every row offset in `OFFSETS` and at both k16 halves of a
   row. K5 (`csrc/hourglass_chain.cu`) starts its A operand at any row, so
   every offset must read the rows and columns TMA wrote (`ok`).
2. `k5`: K5 at the main path's volumes (72 and 44 slices of 80 x 320 x
   32, bf16) as built from `csrc/hourglass_chain.cu`, and variants of the
   same source with parts taken out: no products (`no_mma`), no epilogue
   (`no_epilogue`), no TMA loads (`no_tma`), loads only (`tma_only`), and
   loads only with the boxes of 8 channels (16 bytes) a former design
   used (`tma_only_8ch`); beside them a copy of the chain tensor
   (`clone_chain`) as the card's copy rate. Milliseconds per launch, CUDA
   events around `--reps` launches. The variants compute garbage; only
   `full` is held against the plain version.

Builds into `build/probe/` (git-ignored).
"""

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .ops.conv_chain import conv_s2_plain
from .ops.cuda import build
from .ops.cuda import conv_chain as KC

OUT = build.BUILD_DIR.parent / 'probe'
OFFSETS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 16, 21, 31)

SWIZZLE_SRC = r'''
#include "wgmma.cuh"
using namespace hop;
constexpr int ROWS = 96;
__global__ void probe(const __grid_constant__ CUtensorMap map,
                      const __nv_bfloat16* bsel, float* out, const int* offs,
                      int noffs) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t a_s = smem_u32(smem), b_s = a_s + ROWS * 64;
  const uint32_t bar = b_s + 512;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, ROWS * 64 + 512);
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(a_s),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(0), "r"(0)
        : "memory");
    bulk_load(b_s, bsel, 512, bar);
  }
  mbar_wait(bar, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 0; o < noffs; ++o)
    for (int kk = 0; kk < 2; ++kk)
      for (int sel = 0; sel < 2; ++sel) {
        const uint32_t a = a_s + offs[o] * 64 + kk * 32;
        const uint32_t b = b_s + sel * 256;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        fence_regs(d);
        wgmma_fence();
        wgmma<8>(d, desc_hi_sw64() | (a >> 4), desc_hi(128, 256) | (b >> 4),
                 0u);
        wgmma_commit_wait();
        fence_regs(d);
        for (int i = 0; i < 4; ++i) {
          const int m = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int n = 2 * (lane & 3) + (i & 1);
          out[(((o * 2 + kk) * 2 + sel) * 64 + m) * 8 + n] = d[i];
        }
      }
}
extern "C" int run_probe(const void* g, const void* bsel, float* out,
                         const int* offs, int noffs) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {32, ROWS}, strides[1] = {64};
  const cuuint32_t box[2] = {32, ROWS}, elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(g),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -2;
  const int smem = ROWS * 64 + 512 + 64;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  probe<<<1, 128, smem>>>(map, static_cast<const __nv_bfloat16*>(bsel), out,
                          offs, noffs);
  return (int)cudaDeviceSynchronize();
}
'''

# the parts of csrc/hourglass_chain.cu the variants take out or change
_MMA = 'wgmma<64>(acc, kAHi | (a >> 4), b, scale);'
_EPI = '  epilogue(a, out, ps, rb, m, tile, ntiles, y, x0, H2, W2, tid);'
_TMA = '''          mbar_expect_tx(full, kBox);
          tma_load_4d(ring_a + slot * kSlot, &tmap, full, 0, 2 * x0 + p,
                      2 * y0, s);'''
_TMA_8CH = '''          mbar_expect_tx(full, kBox);
          for (int c8 = 0; c8 < 4; ++c8)
            tma_load_4d(ring_a + slot * kSlot + c8 * 5248, &tmap, full,
                        8 * c8, 2 * x0 + p, 2 * y0, s);'''
_MAP = '''k5::kC, k5::kC, 2 * k5::SXP, k5::SY, 2,
                              CU_TENSOR_MAP_SWIZZLE_64B))'''
_MAP_8CH = '''k5::kC, 8, 2 * k5::SXP, k5::SY, 2,
                              CU_TENSOR_MAP_SWIZZLE_NONE))'''
_NO_MMA = '(void)a; (void)b; (void)scale;'


def _variants(src):
    for part in (_MMA, _EPI, _TMA, _MAP):
        if part not in src:
            raise RuntimeError(f'probe_k5: csrc/hourglass_chain.cu changed; '
                               f'update the variants ({part[:40]!r})')
    loads = src.replace(_MMA, _NO_MMA).replace(_EPI, '')
    return {'full': src, 'no_mma': src.replace(_MMA, _NO_MMA),
            'no_epilogue': src.replace(_EPI, ''),
            'no_tma': src.replace(_TMA, '          mbar_arrive(full);'),
            'tma_only': loads,
            'tma_only_8ch': loads.replace(_TMA, _TMA_8CH).replace(_MAP,
                                                                  _MAP_8CH)}


def _compile(sources):
    """name -> ctypes library, one nvcc per source, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f'{name}.cu'
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, '-I', str(build.CSRC), '-o',
             str(OUT / f'{name}.so'), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        libs[name] = ctypes.CDLL(str(OUT / f'{name}.so'))
    return libs


def _ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def swizzle_check(lib):
    """Rows and columns read back at every start offset: {offset: ok}."""
    lib.run_probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    rows, cols = 96, 32
    sel = np.zeros((2, 2, 8, 8), np.float32)    # [sel][k half][n][k 8]
    for s in range(2):
        for n in range(8):
            sel[s, s, n, n] = 1.0                # picks k = 8 s + n
    bsel = torch.from_numpy(sel.reshape(-1)).to(torch.bfloat16).cuda()
    offs = torch.tensor(OFFSETS, dtype=torch.int32, device='cuda')
    got = {}
    for name, g in (('row', np.arange(rows)[:, None] * np.ones((1, cols))),
                    ('col', np.ones((rows, 1)) * np.arange(cols)[None])):
        t = torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16).cuda()
        out = torch.zeros(len(OFFSETS), 2, 2, 64, 8, device='cuda')
        rc = lib.run_probe(t.data_ptr(), bsel.data_ptr(), out.data_ptr(),
                           offs.data_ptr(), len(OFFSETS))
        if rc:
            raise RuntimeError(f'probe_k5: swizzle probe failed ({rc})')
        got[name] = out.cpu().numpy()
    m, n = np.arange(64)[:, None], np.arange(8)[None]
    ok = {}
    for i, r0 in enumerate(OFFSETS):
        ok[r0] = all(
            np.array_equal(got['row'][i, kk, s], np.broadcast_to(r0 + m,
                                                                 (64, 8)))
            and np.array_equal(got['col'][i, kk, s],
                               np.broadcast_to(16 * kk + 8 * s + n, (64, 8)))
            for kk in range(2) for s in range(2))
    return ok


def k5_times(libs, reps):
    gen = torch.Generator(device='cuda').manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    w64 = torch.randn(64, 32, 3, 3, 3, generator=gen, device='cuda') / 17
    wt = KC.cached_wgmma_weight(w64)
    times = {}
    for depth in (72, 44):
        x = torch.randn(depth, 80, 320, 32, generator=gen,
                        device='cuda').to(torch.bfloat16)
        cv = KC.pack_vol(x)
        d2, h2, w2 = depth // 2, 40, 160
        tiles = (h2 // KC.TILE_S2[0]) * -(-w2 // KC.TILE_S2[1])
        out = torch.empty(d2, h2, w2, 64, dtype=torch.bfloat16,
                          device='cuda')
        ps = torch.empty(d2, tiles, 2, 64, device='cuda')
        row = {}
        for name, lib in libs.items():
            fn = lib.dfm_conv_s2
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]

            def call(fn=fn):
                return fn(cv.data.data_ptr(), wt.data_ptr(), out.data_ptr(),
                          ps.data_ptr(), d2, h2, w2, tiles, sms, stream)
            if call():
                raise RuntimeError(f'probe_k5: {name} did not launch')
            torch.cuda.synchronize()
            if name == 'full':
                want, _ = conv_s2_plain(cv, w64)
                err = float((out.float() - want.float()).abs().max())
                if err > 0.05:
                    raise RuntimeError(f'probe_k5: K5 disagrees ({err})')
            row[name] = _ms(call, reps)
        row['clone_chain'] = _ms(lambda: cv.data.clone(), reps)
        times[f'depth{depth}'] = row
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('probe_k5: needs a CUDA card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    src = (build.CSRC / 'hourglass_chain.cu').read_text()
    libs = _compile({'swizzle': SWIZZLE_SRC, **_variants(src)})
    ok = swizzle_check(libs.pop('swizzle'))
    print(json.dumps({'swizzle': {'card': card, 'offsets': list(OFFSETS),
                                  'ok': all(ok.values()),
                                  'per_offset': ok}}), flush=True)
    print(json.dumps({'k5': {'card': card, 'ms': k5_times(libs, args.reps)}}))
    if not all(ok.values()):
        raise SystemExit('probe_k5: the swizzled descriptor misread rows')


if __name__ == '__main__':
    main()
