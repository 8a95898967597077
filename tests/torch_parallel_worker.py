"""One rank of the process group of the port's data-parallel tests (no
JAX).

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_parallel_worker.py DIR

reads DIR/inputs.pt (the test's inputs: weights, global batches, a KITTI
tree), joins the gloo group on the CPU through `parallel/dist.py:
init_from_env`, runs the port side of each check the inputs name on its
rows of the global batch and writes DIR/rank<r>.pt
(tests/test_torch_parallel.py, tests/test_torch_mvdfm_train.py):

* 'bn': a train-mode `BatchNorm` on the rank's rows: the output, the
  input's gradient, the summed weight / bias gradients and the running
  buffers;
* 'DfM', 'DfMFull', 'MultiViewDfM', 'PGD': one `TrainStep` of the tiny
  model on the rank's rows (the depth pixels the rank's rows of the global
  draw): the loss terms and grad_norm of the global batch, the gradients
  summed over the group, the BatchNorm buffers after the forward, the
  state after the update;
* 'norms': DfMFull's ATSS and imitation losses, dist_norm on, on the
  rank's rows of fixed head outputs and features: the terms summed over
  the group and the gradients to the rank's rows;
* 'infer': `multihost_dataset_inference` of a tiny DfM on the tree;
* 'gather': `allgather_pickled` of an object whose size depends on the
  rank.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dfm_tpu_torch.apis import (allgather_pickled, init_dfm_model,  # noqa
                                multihost_dataset_inference)
from dfm_tpu_torch.data.kitti import KittiDataset  # noqa: E402
from dfm_tpu_torch.models.builder import atss_config, mono_model  # noqa
from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig  # noqa: E402
from dfm_tpu_torch.models.detectors.dfm_full import DfMFull  # noqa: E402
from dfm_tpu_torch.models.detectors.imitation import (  # noqa: E402
    imitation_loss)
from dfm_tpu_torch.models.heads.atss2d import (ATSS2DConfig,  # noqa: E402
                                               atss2d_loss)
from dfm_tpu_torch.models.detectors.multiview_dfm import (  # noqa: E402
    MultiViewDfM, MVDfMConfig)
from dfm_tpu_torch.models.layers import BatchNorm  # noqa: E402
from dfm_tpu_torch.parallel import dist as D  # noqa: E402
from dfm_tpu_torch.runtime.adapters import (mono_to_device,  # noqa
                                            mv_to_device, to_device)
from dfm_tpu_torch.runtime.config import load_config  # noqa: E402
from dfm_tpu_torch.runtime.schedule import liga_schedule  # noqa: E402
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer  # noqa


def batchnorm(inp):
    bn = BatchNorm(inp['x'].shape[1]).train()
    bn.load_state_dict(inp['sd'])
    x = D.shard_batch(torch.from_numpy(inp['x'])).requires_grad_(True)
    gout = D.shard_batch(torch.from_numpy(inp['gout']))
    y = bn(x)
    y.backward(gout)
    D.all_reduce_grads(list(bn.parameters()))
    return dict(y=y.detach(), gx=x.grad, gw=bn.weight.grad,
                gb=bn.bias.grad, sd=bn.state_dict())


def step(kind, inp):
    frozen, pix = (), None
    if kind == 'MultiViewDfM':
        model = MultiViewDfM(MVDfMConfig(**inp['cfg']))
        img, meta, gt = mv_to_device(inp['batch'], 'cpu')
    elif kind == 'PGD':
        model = mono_model(dict(type='PGD', **inp['cfg']))
        img, meta, gt = mono_to_device(inp['batch'], 'cpu')
    else:
        cfg = DfMConfig(**inp['cfg'])
        if kind == 'DfMFull':
            model = DfMFull(cfg, atss_config(load_config(
                inp['config']).model))
            frozen = ('lidar_teacher',)
        else:
            model = DfM(cfg)
        img, meta, gt = to_device(inp['batch'], 'cpu')
        pix = torch.from_numpy(inp['pix'])
    model.load_state_dict(inp['sd'], strict=True)
    train_step = TrainStep(model, make_optimizer(model,
                                                 frozen_prefixes=frozen),
                           liga_schedule(**inp['lr']))
    img, meta, gt, pix = D.shard_batch((img, meta, gt, pix))
    with torch.backends.mkldnn.flags(enabled=False):
        total, losses = train_step.forward(img, meta, gt, depth_pix_idx=pix)
        train_step.backward(total)
    train_step.reduce()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    norm = train_step.update()
    metrics = D.sum_scalars(dict(loss=total.detach(), **{
        k: v.detach() for k, v in losses.items()}))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grad_norm=float(norm), grads=grads, stats=stats,
                after=model.state_dict(), reduce_bytes=train_step.reduce_bytes)


def normalisers(inp):
    """DfMFull's loss terms with normalisers of their own on the rank's
    rows, dist_norm on: term -> (the terms summed over the group, the
    gradients to the rank's rows)."""
    a, im = inp['atss'], inp['imitation']
    outs = [{k: torch.from_numpy(v).requires_grad_() for k, v in o.items()}
            for o in D.shard_batch(a['outs'])]
    leaves = [o[k] for o in outs for k in a['keys']]
    terms = atss2d_loss(outs, a['img_hw'], {
        k: torch.from_numpy(v) for k, v in D.shard_batch(a['gt']).items()},
        ATSS2DConfig(**a['cfg']), dist_norm=True)
    grads = {k: torch.autograd.grad(v, leaves, retain_graph=True,
                                    allow_unused=True)
             for k, v in terms.items()}
    for kind in ('bev', 'volume'):
        student = torch.from_numpy(D.shard_batch(
            im[kind]['student'])).requires_grad_()
        terms[f'imitation_{kind}'] = imitation_loss(
            student, torch.from_numpy(D.shard_batch(im[kind]['teacher'])),
            torch.from_numpy(im['centers']),
            torch.from_numpy(D.shard_batch(im['boxes'])),
            torch.from_numpy(D.shard_batch(im['gmask'])),
            normalizer_clamp_value=2.0, dist_norm=True)
        grads[f'imitation_{kind}'] = torch.autograd.grad(
            terms[f'imitation_{kind}'], [student])
    summed = D.sum_scalars({k: v.detach() for k, v in terms.items()})
    return {k: (float(summed[k]), list(grads[k])) for k in terms}


def infer(inp):
    handle = init_dfm_model(DfMConfig(**inp['cfg']), torch.float32, 'cpu')
    handle['model'].load_state_dict(inp['sd'])
    ds = KittiDataset(inp['root'], inp['infos'], train=False,
                      pipeline_kwargs=dict(crop_size=inp['crop'], max_gt=32))
    return multihost_dataset_inference(handle, ds)


def main(out_dir):
    torch.set_num_threads(1)
    D.init_from_env('cpu')
    inp = torch.load(os.path.join(out_dir, 'inputs.pt'), weights_only=False)
    r = D.rank()
    out = dict(rank=r, world=D.world_size(), backend=D.backend())
    if 'bn' in inp:
        out['bn'] = batchnorm(inp['bn'])
    for kind in ('DfM', 'DfMFull', 'MultiViewDfM', 'PGD'):
        if kind in inp:
            out[kind] = step(kind, inp[kind])
    if 'norms' in inp:
        out['norms'] = normalisers(inp['norms'])
    if 'infer' in inp:
        out['infer'] = infer(inp['infer'])
    out['gather'] = allgather_pickled(
        dict(rank=r, items=list(range(3 * r + 1)),
             array=np.arange(5 + 1000 * r, dtype=np.float32)))
    torch.save(out, os.path.join(out_dir, f'rank{r}.pt'))
    D.destroy()


if __name__ == '__main__':
    main(sys.argv[1])
