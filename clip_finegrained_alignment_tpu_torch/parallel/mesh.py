"""Processes, the ``data × model × pipe`` mesh and host-side data
sharding: the port of ``clip_finegrained_alignment_tpu/parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` over every device of one
program, its devices laid out as ``reshape(data, model, pipe)`` with
``pipe`` minor. The port runs one process a GPU, the reference's and
torchrun's model: ``distributed_init`` joins the ``torch.distributed``
group that torchrun's environment describes, and :class:`Mesh` is this
process's place in it: rank ``r = (d·model + m)·pipe + p`` has data
coordinate ``d``, model coordinate ``m`` (tensor parallelism, or under
``sequence_parallel`` its block of the tokens) and pipe coordinate ``p``
(its pipeline stage), and holds the process groups of its three axes.
Under sequence parallelism the model groups are the sequence groups, and
``sp_ring`` adds the two-rank groups of the ring's hops
(``parallel/sequence.py``).

A process's index and count are ``torch.distributed``'s rank and world
size when a process group is initialized, and 0 and 1 otherwise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import MeshConfig

AXES = ("data", "model", "pipe")


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
    """This process's place in the ``data × model × pipe`` mesh: the axes'
    sizes, this process's global ``rank``, the device it computes on and
    the process groups of its axes (``groups``: axis → the group of the
    ranks that share this rank's other coordinates, None where that is
    every rank: the default group; ``"hop_prev"`` / ``"hop_next"``: the
    two-rank groups of the pipeline hops; ``"ring_prev"`` /
    ``"ring_next"``: those of the sequence ring's hops). A mesh made by
    hand (no ``groups``) runs its collectives on the default group.
    ``sequence_parallel``: the model axis shards tokens, not parameters."""
    data: int
    rank: int
    device: torch.device
    model: int = 1
    pipe: int = 1
    groups: Dict[str, Any] = field(default_factory=dict, compare=False,
                                   repr=False)
    sequence_parallel: bool = False

    @property
    def tensor_parallel(self) -> bool:
        """Whether the model axis splits the parameters (Megatron)."""
        return self.model > 1 and not self.sequence_parallel

    @property
    def data_rank(self) -> int:
        return self.rank // (self.model * self.pipe)

    @property
    def model_rank(self) -> int:
        return self.rank // self.pipe % self.model

    @property
    def pipe_rank(self) -> int:
        return self.rank % self.pipe

    def group(self, axis: str):
        """The process group of ``axis`` (None: the default group)."""
        return self.groups.get(axis)

    def global_rank(self, data: Optional[int] = None,
                    model: Optional[int] = None,
                    pipe: Optional[int] = None) -> int:
        """The global rank at these coordinates, this rank's where None."""
        d = self.data_rank if data is None else data
        m = self.model_rank if model is None else model
        p = self.pipe_rank if pipe is None else pipe
        return (d * self.model + m) * self.pipe + p

    @property
    def backend(self) -> str:
        import torch.distributed as dist
        return dist.get_backend()

    def rows_group(self):
        """Under global negatives, the group whose ranks hold the parts of
        one train microbatch's rows (M = B·S of a projection, the int8
        wgrad's contraction, ``ops/quant.py::Groups.m``): the data ranks,
        and under sequence parallelism the data × model ranks (each model
        rank its token block), which is every rank, as SP runs no
        pipeline; never the pipe ranks (JAX's GPipe ``shard_map``
        quantizes each pipeline microbatch on its own). None when this
        rank holds every row."""
        import torch.distributed as dist
        if self.sequence_parallel and self.model > 1:
            if self.pipe > 1:
                raise ValueError("sequence parallelism runs no pipeline")
            return dist.group.WORLD
        if self.data == 1:
            return None
        group = self.group("data")
        return dist.group.WORLD if group is None else group

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x`` on dim 0, the backward summing
        over them (``collectives.all_gather_with_grad``)."""
        from .collectives import all_gather_with_grad
        return all_gather_with_grad(x, self.group("data"))

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data ranks, no gradient."""
        from .collectives import all_reduce_sum
        return all_reduce_sum(x, self.group("data"))


def axis_ranks(cfg: MeshConfig, axis: str) -> List[List[int]]:
    """The rank sets of ``axis``: one a point of the other two axes, in
    the order of those points, each in the axis's order."""
    sizes = {"data": cfg.data, "model": cfg.model, "pipe": cfg.pipe}
    others = [a for a in AXES if a != axis]
    out = []
    for i in range(sizes[others[0]]):
        for j in range(sizes[others[1]]):
            ranks = []
            for k in range(sizes[axis]):
                c = {others[0]: i, others[1]: j, axis: k}
                ranks.append((c["data"] * cfg.model + c["model"]) * cfg.pipe
                             + c["pipe"])
            out.append(ranks)
    return out


def _new_groups(rank_sets: List[List[int]], rank: int, world: int):
    """``new_group`` for every set, in order, on every rank (the rule of
    ``torch.distributed``), returning this rank's; a set of every rank is
    the default group (None), and makes no group."""
    import torch.distributed as dist
    mine = None
    for ranks in rank_sets:
        if len(ranks) == world:
            return None
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_mesh(cfg: Optional[MeshConfig] = None,
              device: Optional[torch.device] = None, *,
              sequence_parallel: bool = False,
              sp_ring: bool = False) -> Mesh:
    """The mesh over the initialized process group. ``cfg`` None takes
    every rank as a data rank; a ``cfg`` whose product of axes is not the
    group's size raises. ``sequence_parallel``: the model axis is the
    sequence axis; with ``sp_ring`` also the ring's pair groups (ring rank
    i and i + 1 of each model group; at two ranks the model group itself).
    ``sp_ring`` alone changes nothing, as in JAX's step. Every rank makes
    the groups of all three axes and of the pipeline and ring hops, in the
    same order. ``device`` defaults to the current CUDA device, or the CPU
    without one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.mesh.distributed_init)")
    size, rank_ = dist.get_world_size(), dist.get_rank()
    cfg = cfg or MeshConfig(data=size)
    if cfg.data * cfg.model * cfg.pipe != size:
        raise ValueError(f"mesh {cfg.data}x{cfg.model}x{cfg.pipe} needs "
                         f"{cfg.data * cfg.model * cfg.pipe} ranks; the "
                         f"process group has {size}")
    groups = {axis: _new_groups(axis_ranks(cfg, axis), rank_, size)
              for axis in AXES}
    if cfg.pipe > 1:
        # The hops s -> s + 1: one two-rank group each, made on every rank
        # in the same order.
        pairs = [(chain[s], chain[s + 1]) for chain in axis_ranks(cfg, "pipe")
                 for s in range(cfg.pipe - 1)]
        for a, b in pairs:
            g = None if size == 2 else dist.new_group([a, b])
            if rank_ == a:
                groups["hop_next"] = g
            if rank_ == b:
                groups["hop_prev"] = g
    if sequence_parallel and sp_ring and cfg.model > 1:
        # The ring's hops i -> i + 1 (mod n): one two-rank group each.
        for ring in axis_ranks(cfg, "model"):
            n = len(ring)
            for i in range(n):
                a, b = ring[i], ring[(i + 1) % n]
                g = _new_groups([[a, b]], rank_, size) if n > 2 else \
                    groups["model"]
                if rank_ == a:
                    groups["ring_next"] = g
                if rank_ == b:
                    groups["ring_prev"] = g
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    return Mesh(data=cfg.data, rank=rank_, device=torch.device(device),
                model=cfg.model, pipe=cfg.pipe, groups=groups,
                sequence_parallel=sequence_parallel)


def _rows(x, mesh: Mesh, dim: int):
    n = x.shape[dim]
    if n % mesh.data:
        raise ValueError(f"batch dim {n} is not divisible by the "
                         f"{mesh.data} data ranks")
    per, r = n // mesh.data, mesh.data_rank
    index = (slice(None),) * dim + (slice(r * per, (r + 1) * per),)
    return x[index]


def shard_batch(batch: Mapping[str, Any], mesh: Mesh, *,
                accum_axis: bool = False) -> dict:
    """This rank's contiguous rows ``[d·B/D, (d+1)·B/D)`` of a global host
    batch (numpy arrays or tensors, not moved), ``d`` its data coordinate
    of ``D``: of the first dim, or with ``accum_axis`` (leaves ``[accum, B,
    …]``) of the second, as JAX's ``batch_sharding(accum_axis=True)`` lays
    it out. Ranks that share a data coordinate hold the same rows."""
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
    """Overwrite ``tensors`` (e.g. a model's state dict) in place with
    data rank 0's values (the rank of data coordinate 0 that shares this
    rank's model and pipe coordinates, whose shards are the same ones):
    one broadcast over the data group of a flat buffer for each dtype."""
    from .collectives import broadcast_flat_
    broadcast_flat_(list(tensors.values()), src=mesh.global_rank(data=0),
                    group=mesh.group("data"))


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
