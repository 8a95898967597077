"""Data parallelism across processes (torchrun): the process group,
sharded batches, global-batch reductions (`dist.py`) and per-process
sample sharding (`multihost.py`)."""

from . import dist, multihost

__all__ = ['dist', 'multihost']
