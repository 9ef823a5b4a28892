"""Host-side data sharding, the port of the numpy half of
``clip_finegrained_alignment_tpu/parallel/mesh.py``
(``process_shard_bounds``, ``epoch_permutation``). The device mesh, the
batch shardings and the rest of ``parallel/`` come with the multi-GPU
slice.

A process's index and count are ``torch.distributed``'s rank and world
size when a process group is initialized, and 0 and 1 otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _distributed():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def rank() -> int:
    """This process's rank (0 without a process group)."""
    dist = _distributed()
    return dist.get_rank() if dist else 0


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    dist = _distributed()
    return dist.get_world_size() if dist else 1


def process_shard_bounds(num_samples: int,
                         process_index: Optional[int] = None,
                         process_count: Optional[int] = None
                         ) -> Tuple[int, int]:
    """[start, stop) of this process's contiguous shard of a dataset, the
    replacement for ``DistributedSampler``'s partition: every process gets
    ceil(N / count) samples, the last padded by wraparound."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = -(-num_samples // pc)  # ceil
    start = pi * per
    return start, start + per


def epoch_permutation(num_samples: int, epoch: int,
                      seed: int = 42) -> np.ndarray:
    """The epoch's shuffle, the same on every process (``set_epoch``):
    contiguous shards of it never overlap."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(num_samples)
