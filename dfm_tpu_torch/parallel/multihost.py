"""Per-process data sharding and seed agreement.

Port of `dfm_tpu/parallel/multihost.py:25-78` (the reference's
`DistributedSampler` indices and `init_random_seed`'s rank-0 broadcast)
over the process group of `parallel/dist.py`. `global_batch_from_local`
has no counterpart: a rank's rows of the global batch come from
`dist.shard_batch`, whose inverse is the concatenation of the ranks'
rows in rank order.
"""

import numpy as np
import torch
import torch.distributed as dist

from . import dist as D

__all__ = ['host_shard_indices', 'local_batch_size', 'broadcast_seed']


def host_shard_indices(num_samples, epoch, seed=0, drop_last=True,
                       process_index=None, process_count=None):
    """One epoch's sample indices for this process (the group's rank and
    size unless given): the samples shuffled by `RandomState(seed +
    epoch)`, cut (drop_last) or padded from their start to a multiple of
    the process count, then every `process_count`-th from
    `process_index`."""
    pi = D.rank() if process_index is None else process_index
    pc = D.world_size() if process_count is None else process_count
    order = np.random.RandomState(seed + epoch).permutation(num_samples)
    if drop_last:
        order = order[:(num_samples // pc) * pc]
    else:
        pad = (-len(order)) % pc
        if pad:
            order = np.concatenate([order, order[:pad]])
    return order[pi::pc]


def local_batch_size(global_batch, process_count=None):
    """The samples this process contributes per step: the global batch
    over the process count (each process drives one device), which must
    divide it."""
    pc = D.world_size() if process_count is None else process_count
    assert global_batch % pc == 0, (global_batch, pc)
    return global_batch // pc


def broadcast_seed(seed, device=None):
    """Rank 0's seed on every rank; `seed` itself without a group."""
    if not D.is_active():
        return int(seed)
    dev = device if device is not None else (
        torch.device('cuda', torch.cuda.current_device())
        if dist.get_backend() == 'nccl' else torch.device('cpu'))
    t = torch.tensor([int(seed)], dtype=torch.int64, device=dev)
    dist.broadcast(t, 0)
    return int(t.item())
