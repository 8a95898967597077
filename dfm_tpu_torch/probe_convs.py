"""How exact the card's float32 train step of a tiny MultiViewDfM is, and
where its gradient leaves the float64 one.

    python -m dfm_tpu_torch.probe_convs [--hw 64 96] [--top 8] [--watch P]

Needs a CUDA card (`--device cpu` rehearses it, the CPU standing in for
the card). The tiny MultiViewDfM of chip_smoke phase 10 (d) (ResNet-18,
2 views, a (4, 16, 16) grid, seeded live weights, B = 2 of `mv_synth`'s
batch) takes one train-mode step in float64 on the CPU (oneDNN off), in
float32 on the CPU, and in float32 on the card with TF32 off: as it runs,
with cuDNN's deterministic algorithms, and with cuDNN off. JSON lines:

* `step`, per float32 side: the relative L2 against float64 of the
  stages (FPN level 0, the volume, the BEV map, the head outputs, the
  loss), of the whole gradient, of each weight's gradient and of the
  loss's gradient with respect to the stages and to the output of every
  module under `--watch` (default `neck_3d`);
* `relu_flips`, per float32 side: the `F.relu` calls (in call order)
  whose input has another sign than float64's somewhere, the elements
  flipped, and how near 0 they lie in float64 against the input's RMS;
* `convs`: every `F.conv2d` / `F.conv3d` call of the card's step replayed
  alone, its input in the memory format the model gave it (the view
  batch reaches the stem channels-last) and contiguous (NCHW), against
  float64 on the CPU from the same values: the output, and the input and
  weight gradients under a seeded upstream gradient; the worst `--top`
  by each.
"""

import argparse
import json

import torch
import torch.nn.functional as F

from .models.detectors.multiview_dfm import MultiViewDfM, MVDfMConfig
from .runtime.adapters import mv_synth, mv_to_device
from .utils.weights import init_weights

TINY = dict(num_views=2, num_frames=1, feat_channels=16,
            voxel_range=(-8, -8, -1, 8, 8, 3), voxel_grid=(4, 16, 16),
            anchor_ranges=((-8, -8, 0.0, 8, 8, 0.0),) * 3, backbone_depth=18,
            nms_pre=128, max_num=8)


def rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def live_model(cfg, seed=4):
    """chip_smoke's `_live_weights(init_weights(model), 4, 0.0)`."""
    model = init_weights(MultiViewDfM(cfg))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.randn(t.shape, generator=g) * 0.05 * float(
                t.float().abs().mean().clamp(min=0.01))
            if name.endswith('.bias'):
                noise += torch.randn(t.shape, generator=g) * 0.1
            t.add_(noise.to(t.device, t.dtype))
    return model


def stages(model, imgs, l2i, gt, watch='neck_3d'):
    """Train-mode forward, loss and gradients -> (stages, grads); grads
    also holds the loss's gradient with respect to the output of every
    module under `watch` ('d/d <name>')."""
    model.train()
    outputs = {}

    def keep(name):
        def hook(module, args, out):
            if torch.is_tensor(out) and out.requires_grad:
                out.retain_grad()
                outputs[name] = out
        return hook

    handles = [m.register_forward_hook(keep(n))
               for n, m in model.named_modules()
               if n.startswith(watch + '.')]
    feat0 = model.image_features(imgs)
    vol = model.sample_volume(feat0, l2i, tuple(imgs.shape[3:5]))
    bev = model.neck_3d(vol)
    heads = model.bbox_head_3d(bev)
    for t in (feat0, vol, bev, *heads):
        t.retain_grad()
    from .models.detectors.multiview_dfm import mvdfm_loss
    total, _ = mvdfm_loss(dict(zip(('cls_score', 'bbox_pred', 'dir_pred'),
                                   heads)), gt, model.cfg)
    total.backward()
    out = dict(feat0=feat0, volume=vol, bev=bev,
               heads=torch.cat([h.flatten() for h in heads]),
               loss=total.reshape(1))
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    grads.update({f'd/d {k}': v.grad for k, v in (
        ('feat0', feat0), ('volume', vol), ('bev', bev))})
    grads['d/d heads'] = torch.cat([h.grad.flatten() for h in heads])
    grads.update({f'd/d {n}': t.grad for n, t in outputs.items()
                  if t.grad is not None})
    for h in handles:
        h.remove()
    return out, grads


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--hw', type=int, nargs=2, default=(64, 96))
    p.add_argument('--top', type=int, default=8)
    p.add_argument('--watch', default='neck_3d',
                   help='modules whose outputs\' gradients are compared')
    p.add_argument('--device', default='cuda',
                   help="'cpu' rehearses the probe (its 'card' is the CPU)")
    args = p.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('probe_convs needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MVDfMConfig(**TINY)
    batch = mv_synth(cfg, 2, 3, *args.hw)
    sd = live_model(cfg).state_dict()

    runs, calls, recording = {}, [], [False]
    orig = {2: F.conv2d, 3: F.conv3d}
    relu_in, relu_orig = {}, F.relu

    def relu(x, inplace=False):
        relu_in.setdefault(side[0], []).append(x.detach().double().cpu())
        return relu_orig(x, inplace=inplace)

    side = [None]

    def recorder(nd):
        def conv(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
            if recording[0]:
                calls.append((nd, x.detach().clone(
                    memory_format=torch.preserve_format), w.detach(),
                    None if b is None else b.detach(), stride, padding,
                    dilation, groups))
            return orig[nd](x, w, b, stride, padding, dilation, groups)
        return conv

    sides = (('f64', 'cpu', torch.float64, {}),
             ('cpu', 'cpu', torch.float32, {}),
             ('card', args.device, torch.float32, {}),
             ('card, cudnn deterministic', args.device, torch.float32,
              dict(deterministic=True)),
             ('card, cudnn off', args.device, torch.float32,
              dict(enabled=False)))
    for name, dev, dtype, cudnn in sides:
        recording[0] = name == 'card'
        model = MultiViewDfM(cfg)
        model.load_state_dict(sd)
        model = model.to(dev, dtype)
        imgs, l2i, gt = mv_to_device(batch, dev)
        F.conv2d, F.conv3d = recorder(2), recorder(3)
        F.relu, side[0] = relu, name
        try:
            with torch.backends.mkldnn.flags(enabled=name != 'f64'), \
                    torch.backends.cudnn.flags(**dict(
                        dict(enabled=True, benchmark=False,
                             deterministic=False, allow_tf32=False),
                        **cudnn)):
                runs[name] = stages(model, imgs.to(dtype), l2i.to(dtype), gt,
                                    args.watch)
        finally:
            F.conv2d, F.conv3d = orig[2], orig[3]
            F.relu = relu_orig
    out64, g64 = runs['f64']
    # ReLUs whose input changes sign against float64: per call (in call
    # order) the elements flipped, and how far from 0 they lie in float64
    # against the input's RMS
    for name, *_ in sides[1:]:
        flips = []
        for i, (x, x64) in enumerate(zip(relu_in[name], relu_in['f64'])):
            f = (x > 0) != (x64 > 0)
            if f.any():
                v = x64[f].abs()
                flips.append(dict(call=i, shape=list(x.shape), n=int(f.sum()),
                                  max_rel=float(v.max() / x64.pow(2).mean()
                                                .sqrt()),
                                  distinct=int(x64[f].unique().numel())))
        print(json.dumps(dict(part='relu_flips', side=name, hw=list(args.hw),
                              n_calls=len(relu_in[name]), flips=flips)))
    for name, *_ in sides[1:]:
        out, g = runs[name]
        params = [n for n in g64 if not n.startswith('d/d')]
        print(json.dumps(dict(
            part='step', side=name, hw=list(args.hw),
            stages={k: rel(v, out64[k]) for k, v in out.items()},
            grads_whole=rel(torch.cat([g[n].flatten() for n in params]),
                            torch.cat([g64[n].flatten() for n in params])),
            grads={n: rel(g[n], g64[n]) for n in g64
                   if n.startswith('d/d') or n.endswith('weight')})))

    gen = torch.Generator().manual_seed(0)
    rows = []
    for i, (nd, x, w, b, stride, padding, dilation, groups) in \
            enumerate(calls):
        fn = orig[nd]
        y = fn(x, w, b, stride, padding, dilation, groups)
        g = torch.randn(y.shape, generator=gen).to(y.device)
        want = {}
        x64 = x.detach().double().cpu().requires_grad_()
        w64 = w.detach().double().cpu().requires_grad_()
        b64 = None if b is None else b.double().cpu()
        with torch.backends.mkldnn.flags(enabled=False):
            y64 = fn(x64, w64, b64, stride, padding, dilation, groups)
            gx64, gw64 = torch.autograd.grad(y64, (x64, w64),
                                             g.double().cpu())
        row = dict(call=i, nd=nd, x=list(x.shape), w=list(w.shape),
                   stride=stride, channels_last=bool(
                       x.dim() == 4 and x.is_contiguous(
                           memory_format=torch.channels_last)
                       and not x.is_contiguous()))
        for form, xin in (('as_run', x), ('nchw', x.contiguous())):
            xin = xin.detach().requires_grad_()
            wr = w.detach().requires_grad_()
            yr = fn(xin, wr, b, stride, padding, dilation, groups)
            gx, gw = torch.autograd.grad(yr, (xin, wr), g)
            want[form] = dict(out=rel(yr, y64), grad_x=rel(gx, gx64),
                              grad_w=rel(gw, gw64))
        row.update(want)
        rows.append(row)
    for key in ('out', 'grad_x', 'grad_w'):
        worst = sorted(rows, key=lambda r: -r['as_run'][key])[:args.top]
        print(json.dumps(dict(part='convs', worst_by=key, hw=list(args.hw),
                              n_calls=len(rows), rows=worst)))


if __name__ == '__main__':
    main()
