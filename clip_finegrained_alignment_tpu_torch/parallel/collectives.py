"""The collectives of data, tensor and pipeline parallelism over
``torch.distributed``: the port's own module (the JAX package lets XLA
insert them). Each takes the process group of its mesh axis
(``parallel/mesh.py::Mesh.group``; None: the default group).

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
* Megatron's two operators on the ``model`` group:
  :func:`copy_to_model` (identity forward, all-reduce of the gradient
  backward) in front of a column-parallel layer, :func:`reduce_from_model`
  (all-reduce forward, identity backward) after a row-parallel one. Both
  sum in the activations' dtype, as GSPMD's all-reduce of a bf16 product
  does in the JAX package; at two model ranks that is the fp32 sum
  rounded once.
* :func:`broadcast_from`: one rank's tensor to the others of a group: the
  pipeline's stage-to-stage hop (a two-rank group) and the last stage's
  outputs to every stage.
* The int8 products' two (``ops/quant.py``, a dimension split over a
  group): :func:`all_reduce_absmax`, the elementwise MAX of fp32 absmax
  vectors, and :func:`all_reduce_sum_`, the exact sum of int32 partial
  sums.

Route: each backend takes one, the same calls for both: ``all_reduce``
(SUM, MAX), ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``broadcast`` and ``barrier``. ``nccl`` runs them on CUDA tensors; ``gloo``
runs them on CPU tensors and, on torch 2.11 (the card's), on CUDA tensors
too (it stages them through the host itself; probed in ``chip_smoke.py``
phase 10). gloo lacks the list ``all_to_all`` and ``all_reduce_coalesced``
for CUDA tensors, so this module uses neither; the pipeline hop is a
``broadcast`` in a two-rank group rather than ``send``/``recv``, for the
same reason: one route that both backends run. Any other backend raises,
and a collective a backend cannot run raises from ``torch.distributed``:
nothing is copied to the CPU or sent to one rank behind the caller.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _world(group=None) -> int:
    backend = dist.get_backend()
    if backend not in BACKENDS:
        raise RuntimeError(f"backend {backend!r}: the collectives run on "
                           f"{BACKENDS}")
    return dist.get_world_size(group)


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated on dim 0
    in rank order; no gradient."""
    W = _world(group)
    out = x.new_empty((W * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad):
        W = _world(ctx.group)
        out = grad.new_empty((grad.shape[0] // W,) + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad.contiguous(),
                                   op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_gather_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_gather_cat` whose backward sums over the ranks."""
    return _AllGatherWithGrad.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; no gradient)."""
    _world(group)
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max_flag(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is True on any."""
    _world()
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None,
                     mean: bool = True) -> None:
    """Replace each tensor by its mean (``mean=False``: its sum) over the
    ranks: one all-reduce (SUM, then × 1/W) of one flat fp32 buffer."""
    W = _world(group)
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if mean:
        flat.mul_(1.0 / W)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.detach().copy_(flat[offset:offset + n].view_as(t))
        offset += n


def broadcast_flat_(tensors: Sequence[torch.Tensor],
                    src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` with (global) rank ``src``'s values: one
    broadcast of one flat buffer for each dtype."""
    _world(group)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group_tensors])
        dist.broadcast(flat, src=src, group=group)
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
                      dims: Sequence[Optional[int]], group=None
                      ) -> List[torch.Tensor]:
    """Every rank's ``shards`` (same shapes and one dtype on every rank)
    put back whole along their ``dims``: one ``all_gather_into_tensor``.
    A dim of None stacks the ranks' tensors on a new dim 0 (e.g. a
    stage's layers, one a rank)."""
    W = _world(group)
    if not shards:
        return []
    flat = torch.cat([s.detach().reshape(-1) for s in shards])
    out = flat.new_empty((W, flat.numel()))
    dist.all_gather_into_tensor(out.view(-1), flat, group=group)
    whole, offset = [], 0
    for s, d in zip(shards, dims):
        n = s.numel()
        parts = out[:, offset:offset + n].reshape((W,) + tuple(s.shape))
        whole.append(parts.clone() if d is None
                     else torch.cat(parts.unbind(0), dim=d))
        offset += n
    return whole


def reduce_scatter_shards(tensors: Sequence[torch.Tensor],
                          dims: Sequence[int], group=None
                          ) -> List[torch.Tensor]:
    """This rank's part (split along ``dims``) of the mean over the ranks
    of each rank's ``tensors``: one
    ``reduce_scatter_tensor`` of one flat buffer laid out as W rows, row j
    holding every tensor's j-th part."""
    W = _world(group)
    if not tensors:
        return []
    chunks = [t.detach().chunk(W, d) for t, d in zip(tensors, dims)]
    flat = torch.cat([c[j].reshape(-1) for j in range(W) for c in chunks])
    out = flat.new_empty(flat.numel() // W)
    dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=group)
    out.mul_(1.0 / W)
    parts, offset = [], 0
    for c in chunks:
        n = c[0].numel()
        parts.append(out[offset:offset + n].view(c[0].shape))
        offset += n
    return parts


# ---------------------------------------------------------------------------
# Tensor parallelism: Megatron's two operators on the model group
# ---------------------------------------------------------------------------

def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, in ``x``'s dtype (a new
    tensor)."""
    _world(group)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the model
    ranks (each column-parallel shard contributes its part of dx)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model ranks of a row-parallel layer's partial
    products; identity backward."""
    return _ReduceFromModel.apply(x, group)


# ---------------------------------------------------------------------------
# Int8 products over a split dimension (ops/quant.py)
# ---------------------------------------------------------------------------

def all_reduce_absmax(vectors: Sequence[torch.Tensor],
                      group) -> List[torch.Tensor]:
    """The elementwise MAX over the group of each fp32 vector of absolute
    values (absmax: ≥ 0, or a NaN with its sign clear, as ``fabsf`` and
    ``abs`` leave it), for all of them in one all-reduce. It runs on their
    bits as int32: a non-negative float's bits order as the float does and
    a NaN's lie above +inf's, so a NaN on any rank wins on every rank, as
    the fused passes' ``nan_max`` keeps it, where gloo's and NCCL's float
    MAX promise nothing for NaN."""
    _world(group)
    flat = torch.cat([v.reshape(-1).float() for v in vectors])
    bits = flat.view(torch.int32)
    dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=group)
    out, offset = [], 0
    for v in vectors:
        out.append(flat[offset:offset + v.numel()].view(v.shape))
        offset += v.numel()
    return out


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (int32 sums, contiguous) replaced by its sum over the group:
    exact, in any order."""
    _world(group)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


# ---------------------------------------------------------------------------
# Pipeline parallelism: the stage-to-stage hop and the outputs' fan-out
# ---------------------------------------------------------------------------

def broadcast_from(x: Optional[torch.Tensor], src: int, group,
                   shape=None, dtype=None, device=None) -> torch.Tensor:
    """One tensor from global rank ``src`` to the other ranks of
    ``group``: the sender passes ``x``, a receiver ``None`` and the
    ``shape``, ``dtype`` and ``device`` to receive into. A ``broadcast``,
    which both backends run on CUDA tensors."""
    _world(group)
    if x is None:
        x = torch.empty(shape, dtype=dtype, device=device)
    else:
        x = x.detach().contiguous()
    dist.broadcast(x, src=src, group=group)
    return x
