"""Inference entry points. Port of `dfm_tpu/apis.py:18-52, 182-217`.

They run on the CUDA card by default and raise when there is none; the
CPU is used only when the caller passes device='cpu'. Weights are
random from seed 0 (`utils/weights.py:init_weights`) until a checkpoint
is loaded into `handle['model']` with `load_state_dict`.

`use_band` and `packed` select the form of the 3D trunks
(`models/backbones/dfm_backbone.py`). The default (`packed=None`) is, for
bfloat16, the full conv chain: banded stems, reduced-depth mono trunk,
and both trunks in the chain format from the cost volume to the pred
exit (kernels K4-K8b), where the shapes allow it; `packed=True` asks for
it in any dtype (float32 on the CPU only) and warns when a trunk's
shapes send it to the `'stem'` form. `packed='stem'` keeps only
the stereo stem and pred ConvNorm on the chain (K4, K7a, K8a),
`packed=False` is the banded form without the chain, `use_band=False,
packed=False` the dense form. One state dict loads into every form.
"""

import torch

from .models.detectors.dfm import DfM, DfMConfig, dfm_predict
from .utils.weights import init_weights

__all__ = ['init_dfm_model', 'init_dfm_stream']


def _device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('dfm_tpu_torch runs on a CUDA device; pass '
                               "device='cpu' to run on the CPU")
        return torch.device('cuda')
    return torch.device(device)


def _build(cfg, dtype, device, use_band, packed):
    cfg = cfg or DfMConfig()
    device = _device(device)
    with torch.device('meta'):
        model = DfM(cfg, dtype=dtype, use_band=use_band, packed=packed)
    model = init_weights(model.to_empty(device=device)).eval()
    return cfg, device, model


def init_dfm_model(cfg=None, dtype=torch.bfloat16, device=None,
                   use_band=True, packed=None):
    """Build a DfM model and its inference function.

    Returns dict(model, cfg, device, infer) with
    infer(img (B, 2, H, W, 3), meta) -> padded detections dict.
    """
    cfg, device, model = _build(cfg, dtype, device, use_band, packed)

    @torch.inference_mode()
    def infer(img, meta):
        return dfm_predict(model(img, meta), cfg)

    return dict(model=model, cfg=cfg, device=device, infer=infer)


def init_dfm_stream(cfg=None, dtype=torch.bfloat16, device=None,
                    use_band=True, packed=None):
    """Streaming video inference with prev-frame feature reuse: the first
    frame of a sequence runs the two-frame path, every later step one
    backbone + neck pass on the new frame and the cached stereo features
    of the previous one (exact when consecutive frames share
    scale / flip).

    Returns dict(model, cfg, device, infer_first, infer_stream):
        infer_first(img2 (B, 2, H, W, 3), meta) -> (dets, cache)
        infer_stream(img1 (B, H, W, 3), meta, cache) -> (dets, cache)
    """
    cfg, device, model = _build(cfg, dtype, device, use_band, packed)

    @torch.inference_mode()
    def infer_first(img, meta):
        out = model(img, meta)
        return dfm_predict(out, cfg), out['stereo_cache']

    @torch.inference_mode()
    def infer_stream(img_cur, meta, cache):
        img2 = torch.stack([img_cur, img_cur], dim=1)
        out = model(img2, meta, prev_stereo_cache=cache)
        return dfm_predict(out, cfg), out['stereo_cache']

    return dict(model=model, cfg=cfg, device=device,
                infer_first=infer_first, infer_stream=infer_stream)
