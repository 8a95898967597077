"""The process group of data-parallel training and evaluation.

Port of `dfm_tpu/parallel/mesh.py:1-51` (one data axis: the batch split on
dim 0, parameters replicated) for processes launched by torchrun, one per
rank. JAX's CLI computes the loss once on the whole sharded batch
(`tools/train.py:550-552`), so every loss normaliser is a count over the
global batch and the BatchNorm moments are those of the global batch. The
port keeps those semantics in a group:

* each rank computes its share of the global batch's loss: the
  normalisers are summed over the group (`global_sum`) and the per-batch
  means divide by the global batch, so the global loss is the sum of the
  ranks' losses;
* the gradients are therefore summed over the group, not averaged
  (`all_reduce_grads`), and the reported loss terms too (`sum_scalars`);
* train-mode BatchNorm takes its moments over a group of several ranks
  (`models/layers.py:BatchNorm` through `sum_over_group`, an all-reduce
  whose backward all-reduces the gradient).

Without torchrun's environment no group is made, and every function here
is the identity of one process: the single-process path is unchanged.

Backend: `nccl` when every rank of a host has a card of its own, else
`gloo` (NCCL refuses two ranks on one card; gloo all-reduces CUDA
tensors through the host). A rank on the CPU takes gloo.
"""

import dataclasses
import os

import torch
import torch.distributed as dist

__all__ = ['init_from_env', 'is_active', 'rank', 'world_size', 'is_main',
           'barrier', 'backend', 'backend_for', 'shard_batch', 'global_sum',
           'sum_over_group', 'sum_scalars', 'all_reduce_grads',
           'broadcast_module', 'destroy']


def is_active():
    """True when a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_active() else 0


def world_size():
    return dist.get_world_size() if is_active() else 1


def is_main():
    """Rank 0 (the only process without a group) writes checkpoints,
    metrics and the evaluation's output."""
    return rank() == 0


def backend():
    """The group's backend ('nccl' or 'gloo'), None without a group."""
    return dist.get_backend() if is_active() else None


def barrier():
    if is_active():
        dist.barrier()


def backend_for(device, local_world_size):
    """`nccl` for ranks on CUDA cards when the host has a card for each of
    its `local_world_size` ranks; `gloo` otherwise."""
    if device.type == 'cuda' and \
            torch.cuda.device_count() >= local_world_size:
        return 'nccl'
    return 'gloo'


def init_from_env(device=None):
    """Join the group that torchrun's RANK / WORLD_SIZE / LOCAL_RANK (and
    MASTER_ADDR / MASTER_PORT) describe, and return this rank's device:
    `device` when given ('cpu': every rank on the CPU), else the CUDA
    card LOCAL_RANK (modulo the cards present: ranks share a card when
    there are fewer). Without RANK in the environment no group is made and
    the device is `device`, or the CUDA card (RuntimeError without one),
    as the single-process entry points take it. Calling it again in a
    process with a group returns the device without a new group."""
    if device is not None:
        dev = torch.device(device)
    elif not torch.cuda.is_available():
        raise RuntimeError('dfm_tpu_torch runs on a CUDA device; pass '
                           "device='cpu' to run on the CPU")
    else:
        dev = torch.device('cuda')
    if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
        return dev
    local_rank = int(os.environ.get('LOCAL_RANK', 0))
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', local_rank % torch.cuda.device_count())
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if not is_active():
        local_world = int(os.environ.get('LOCAL_WORLD_SIZE',
                                         os.environ['WORLD_SIZE']))
        name = backend_for(dev, local_world)
        kwargs = dict(device_id=dev) if name == 'nccl' else {}
        dist.init_process_group(name, rank=int(os.environ['RANK']),
                                world_size=int(os.environ['WORLD_SIZE']),
                                **kwargs)
    return dev


def destroy():
    if is_active():
        dist.destroy_process_group()


def shard_batch(batch):
    """This rank's rows of a global batch: dim 0 of every tensor or numpy
    array (in dicts, lists, tuples and dataclasses such as `BatchMeta`)
    split into `world_size()` equal consecutive blocks, block `rank()`
    taken, as `dfm_tpu/parallel/mesh.py:shard_batch` puts them on the
    mesh's devices. The batch itself without a group."""
    n, r = world_size(), rank()
    if n == 1:
        return batch

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: take(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        if x is None or not hasattr(x, 'shape') or len(x.shape) == 0:
            return x
        b = x.shape[0]
        if b % n:
            raise ValueError(f'a global batch of {b} does not split over '
                             f'{n} ranks')
        return x[r * (b // n):(r + 1) * (b // n)]

    return take(batch)


def global_sum(x):
    """The sum of tensor `x` over the group (no gradient: counts and
    normalisers); `x` itself without a group."""
    if not is_active():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: with the
    global loss the sum of the ranks' losses, d loss / d x_r is the sum
    over the ranks of their gradients w.r.t. the reduced value."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def sum_over_group(x):
    """The sum of `x` over the group, differentiable (BatchNorm's
    moments); `x` itself without a group."""
    return _SumOverGroup.apply(x) if is_active() else x


def sum_scalars(values):
    """dict of scalar tensors -> the same keys summed over the group in one
    all-reduce (the global batch's loss terms); the dict itself without
    a group."""
    if not is_active() or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(flat)
    return dict(zip(keys, flat.unbind()))


def all_reduce_grads(params):
    """Sum the gradients of `params` over the group in one flat float32
    bucket, in place; returns the bucket's bytes (0 without a group).
    Parameters without a gradient are skipped (every rank must agree:
    `TrainStep.reduce` gives each one a zero gradient first)."""
    if not is_active():
        return 0
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return 0
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    return flat.numel() * flat.element_size()


def broadcast_module(module):
    """Rank 0's parameters and buffers copied to every rank (one broadcast
    per tensor), so that the replicas start equal."""
    if not is_active():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)
