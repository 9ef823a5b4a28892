"""Processes, the data mesh and host-side data sharding: the port of
``clip_finegrained_alignment_tpu/parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` over every device of one
program. The port runs one process a GPU, the reference's and torchrun's
model: ``distributed_init`` joins the ``torch.distributed`` group that
torchrun's environment describes, and :class:`Mesh` is this process's
view of it (its rank, the number of data-parallel ranks and its
device). The ``model`` and ``pipe`` axes (tensor and pipeline
parallelism) are ROADMAP A6b: ``make_mesh`` refuses them.

A process's index and count are ``torch.distributed``'s rank and world
size when a process group is initialized, and 0 and 1 otherwise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import MeshConfig

A6B = ("tensor, pipeline and sequence parallelism are not ported yet "
       "(ROADMAP A6b)")


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


def distributed_init(device="cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group torchrun describes and return this rank's
    device.

    One process (no ``WORLD_SIZE`` in the environment and no group): no
    group is made and ``device`` comes back as it is, index included.
    Under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) a ``cuda`` device is
    ``cuda:{LOCAL_RANK}``: it raises if that GPU is not visible (nothing
    wraps it onto another) or if ``device`` names another index; the
    backend is ``nccl`` for ``cuda`` and ``gloo`` for ``cpu``, unless
    ``backend`` says otherwise. A group that is already initialized is
    used as it is (a caller may hand in a gloo group for CUDA tensors)."""
    import torch.distributed as dist
    dev = torch.device(device)
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        if dev.index is not None and dev.index != local:
            raise ValueError(f"device {dev} but LOCAL_RANK {local}: each "
                             "rank computes on cuda:LOCAL_RANK")
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(f"LOCAL_RANK {local} but {count} CUDA "
                               "device(s) are visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        **({"device_id": dev}
           if dev.type == "cuda" and backend in (None, "nccl") else {}))
    return dev


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data mesh: ``data`` ranks (every rank
    of the default process group), this one ``rank`` and the device this
    rank computes on."""
    data: int
    rank: int
    device: torch.device

    @property
    def backend(self) -> str:
        import torch.distributed as dist
        return dist.get_backend()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` on dim 0, the backward summing over
        the ranks (``collectives.all_gather_with_grad``)."""
        from .collectives import all_gather_with_grad
        return all_gather_with_grad(x)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, no gradient."""
        from .collectives import all_reduce_sum
        return all_reduce_sum(x)


def make_mesh(cfg: Optional[MeshConfig] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """The ``data`` mesh over the initialized process group (every rank a
    data rank). ``cfg`` None takes the group's size; a ``cfg`` whose
    ``data`` differs from it, or with ``model`` or ``pipe`` above 1,
    raises. ``device`` defaults to the current CUDA device, or the CPU
    without one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.mesh.distributed_init)")
    size = dist.get_world_size()
    cfg = cfg or MeshConfig(data=size)
    if cfg.model > 1 or cfg.pipe > 1:
        raise ValueError(f"mesh {cfg.data}x{cfg.model}x{cfg.pipe}: {A6B}")
    if cfg.data != size:
        raise ValueError(f"mesh data={cfg.data} but the process group has "
                         f"{size} rank(s)")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    return Mesh(data=size, rank=dist.get_rank(), device=torch.device(device))


def _rows(x, mesh: Mesh, dim: int):
    n = x.shape[dim]
    if n % mesh.data:
        raise ValueError(f"batch dim {n} is not divisible by the "
                         f"{mesh.data} data ranks")
    per = n // mesh.data
    index = (slice(None),) * dim + (slice(mesh.rank * per,
                                          (mesh.rank + 1) * per),)
    return x[index]


def shard_batch(batch: Mapping[str, Any], mesh: Mesh, *,
                accum_axis: bool = False) -> dict:
    """This rank's contiguous rows ``[r·B/W, (r+1)·B/W)`` of a global host
    batch (numpy arrays or tensors, not moved): of the first dim, or with
    ``accum_axis`` (leaves ``[accum, B, …]``) of the second, as JAX's
    ``batch_sharding(accum_axis=True)`` lays it out."""
    dim = 1 if accum_axis else 0
    return {k: _rows(x, mesh, dim) for k, x in batch.items()}


def shard_batch_from_local(local_batch: Mapping[str, Any], mesh: Mesh, *,
                           accum_axis: bool = False,
                           rows: Optional[int] = None) -> dict:
    """A batch that already holds only this rank's rows (its pipeline read
    its own shard of the data): returned as it is, after checking that
    every leaf has ``rows`` on the batch dim (``B/W``; None: that they
    agree). A rank handed the global batch fails here rather than train
    on W times it."""
    dim = 1 if accum_axis else 0
    sizes = {np.shape(x)[dim] for x in local_batch.values()}
    if len(sizes) > 1 or (rows is not None and sizes != {rows}):
        raise ValueError(
            f"rank batch of {sorted(sizes)} rows on dim {dim}; this rank of "
            f"{mesh.data} takes {rows} (build each rank's pipeline with "
            "effective_batch_size / W)")
    return dict(local_batch)


def replicate(tensors: Mapping[str, torch.Tensor], mesh: Mesh) -> None:
    """Overwrite ``tensors`` (e.g. a model's state dict) in place with rank
    0's values: one broadcast of a flat buffer for each dtype."""
    from .collectives import broadcast_flat_
    broadcast_flat_(list(tensors.values()), src=0)


# ---------------------------------------------------------------------------
# Host-side data sharding (each process loads its own slice)
# ---------------------------------------------------------------------------

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
