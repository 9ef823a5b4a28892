"""The collectives of data parallelism over ``torch.distributed``: the
port's own module (the JAX package lets XLA insert them).

* :func:`all_gather_with_grad`: the rows of every rank in rank order; its
  backward **sums** the cotangent over the ranks and keeps this rank's
  rows (a reduce-scatter), so that a loss every rank computes on the
  gathered rows, followed by a mean of the gradients over the ranks,
  gives the gradient of that one loss.
* :func:`all_reduce_mean_`: one all-reduce of one flat fp32 buffer for a
  list of tensors (the gradients, the losses), never one call a tensor.
* :func:`all_gather_shards` / :func:`reduce_scatter_shards`: tensors split
  along a dim each (``parallel/sharding_rules.py``) gathered whole, or
  averaged over the ranks and split, through one flat buffer each.
* :func:`broadcast_flat_`: rank 0's values to every rank, a buffer a
  dtype.

Route: each backend takes one, the same calls for both: ``all_reduce``
(SUM, MAX), ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``broadcast`` and ``barrier``. ``nccl`` runs them on CUDA tensors; ``gloo``
runs them on CPU tensors and, on torch 2.11 (the card's), on CUDA tensors
too (it stages them through the host itself; probed in ``chip_smoke.py``
phase 10). gloo lacks the list ``all_to_all`` and ``all_reduce_coalesced``
for CUDA tensors, so this module uses neither. Any other backend raises,
and a collective a backend cannot run raises from ``torch.distributed``:
nothing is copied to the CPU or sent to one rank behind the caller.
Every collective runs on the default process group: the data ranks are
all the ranks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _world() -> int:
    backend = dist.get_backend()
    if backend not in BACKENDS:
        raise RuntimeError(f"backend {backend!r}: the data-parallel "
                           f"collectives run on {BACKENDS}")
    return dist.get_world_size()


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated on dim 0
    in rank order; no gradient."""
    W = _world()
    out = x.new_empty((W * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous())
    return out


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_gather_cat(x)

    @staticmethod
    def backward(ctx, grad):
        W = _world()
        out = grad.new_empty((grad.shape[0] // W,) + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad.contiguous(),
                                   op=dist.ReduceOp.SUM)
        return out


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_gather_cat` whose backward sums over the ranks."""
    return _AllGatherWithGrad.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; no gradient)."""
    _world()
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_max_flag(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is True on any."""
    _world()
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks: one all-reduce
    (SUM, then × 1/W) of one flat fp32 buffer."""
    W = _world()
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.mul_(1.0 / W)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.detach().copy_(flat[offset:offset + n].view_as(t))
        offset += n


def broadcast_flat_(tensors: Sequence[torch.Tensor],
                    src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s values: one broadcast of
    one flat buffer for each dtype."""
    _world()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group_tensors])
        dist.broadcast(flat, src=src)
        offset = 0
        for t in group_tensors:
            n = t.numel()
            t.detach().copy_(flat[offset:offset + n].view_as(t))
            offset += n


def shard(x: torch.Tensor, dim: Optional[int], rank: int,
          world: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``x`` split ``world`` ways along ``dim`` (a
    view), or ``x`` itself when ``dim`` is None."""
    return x if dim is None else x.chunk(world, dim)[rank]


def all_gather_shards(shards: Sequence[torch.Tensor],
                      dims: Sequence[int]) -> List[torch.Tensor]:
    """Every rank's ``shards`` (same shapes and one dtype on every rank)
    put back whole along their ``dims``: one ``all_gather_into_tensor``."""
    W = _world()
    if not shards:
        return []
    flat = torch.cat([s.detach().reshape(-1) for s in shards])
    out = flat.new_empty((W, flat.numel()))
    dist.all_gather_into_tensor(out.view(-1), flat)
    whole, offset = [], 0
    for s, d in zip(shards, dims):
        n = s.numel()
        parts = out[:, offset:offset + n].reshape((W,) + tuple(s.shape))
        whole.append(torch.cat(parts.unbind(0), dim=d))
        offset += n
    return whole


def reduce_scatter_shards(tensors: Sequence[torch.Tensor],
                          dims: Sequence[int]) -> List[torch.Tensor]:
    """This rank's part (split along ``dims``) of the mean over the ranks
    of each rank's ``tensors``: one
    ``reduce_scatter_tensor`` of one flat buffer laid out as W rows, row j
    holding every tensor's j-th part."""
    W = _world()
    if not tensors:
        return []
    chunks = [t.detach().chunk(W, d) for t, d in zip(tensors, dims)]
    flat = torch.cat([c[j].reshape(-1) for j in range(W) for c in chunks])
    out = flat.new_empty(flat.numel() // W)
    dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM)
    out.mul_(1.0 / W)
    parts, offset = [], 0
    for c in chunks:
        n = c[0].numel()
        parts.append(out[offset:offset + n].view(c[0].shape))
        offset += n
    return parts
