"""ZeRO-1 and FSDP over the data ranks: which parameters are split along
which dim (``sharding_rules.data_shard_dim``), this rank's parts of them
("shards"), and the collectives that move between whole tensors and parts
(``collectives.py``). The port of what GSPMD does from the JAX package's
``zero1_opt_shardings`` and ``fsdp_param_shardings``.

* **ZeRO-1.** Parameters and gradients stay whole on every rank; the
  optimizer steps this rank's shard of each parameter, a view into the
  parameter, so its moments and anchors are 1/W of the replicated ones.
  After the step every rank's updated shards are all-gathered into the
  parameters (:meth:`ShardLayout.publish`).
* **FSDP.** Between steps a rank keeps only its shards, standalone
  tensors, and the model's split parameters hold no storage. A step
  gathers the whole parameters into the model
  (:meth:`ShardLayout.gather_params`), runs forward and backward,
  reduce-scatters the gradients into the shards' ``.grad`` (mean over the
  ranks) and frees the whole copies (:meth:`ShardLayout.reduce_grads`).
  The whole model is gathered at the step's start; gathering layer by
  layer is a later perf PR.

A tensor the rule leaves whole (a scalar, a dim the rank count does not
divide) is its own shard on every rank: every rank updates it the same
way from the same mean gradient. AdamSPD's per-tensor sums and FSDP's
gradient norm are sums over a tensor's parts: :meth:`reduce_sums` adds
them over the ranks in one all-reduce a step, counting a whole tensor's
row once (rank 0's).

Checkpoints hold whole tensors in the replicated layout's format:
:meth:`full_params` and :meth:`full_optimizer_state` gather them (every
rank takes part), :meth:`load_params` and :meth:`shard_optimizer_state`
split them again, at any rank count.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from . import collectives as C
from .mesh import Mesh
from .sharding_rules import data_shard_dim


class ShardLayout:
    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 mesh: Mesh, fsdp: bool):
        self.mesh = mesh
        self.fsdp = fsdp
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.dims = [data_shard_dim(tuple(p.shape), mesh.data)
                     for p in self.params]
        self.shards: List[torch.Tensor] = []
        for p, d in zip(self.params, self.dims):
            if d is None:
                self.shards.append(p)
            else:
                s = self.part(p.detach(), d)
                self.shards.append(s.clone() if fsdp else s)
        self._split = [i for i, d in enumerate(self.dims) if d is not None]
        self._whole = [i for i, d in enumerate(self.dims) if d is None]
        self._index = {id(s): i for i, s in enumerate(self.shards)}
        if fsdp:
            self.release()

    def part(self, x: torch.Tensor, d: int) -> torch.Tensor:
        return C.shard(x, d, self.mesh.rank, self.mesh.data)

    def index(self, t: torch.Tensor) -> int:
        """The layout index of shard ``t`` (the optimizer's own tensor)."""
        return self._index[id(t)]

    # -- the step ------------------------------------------------------

    def release(self) -> None:
        """FSDP: drop the whole copies of the split parameters."""
        for i in self._split:
            self.params[i].data = self.params[i].data.new_empty(0)
            self.params[i].grad = None

    def gather_params(self) -> None:
        """FSDP: every rank's shards gathered whole into the model."""
        whole = C.all_gather_shards([self.shards[i] for i in self._split],
                                    [self.dims[i] for i in self._split])
        for i, w in zip(self._split, whole):
            self.params[i].data = w

    def reduce_grads(self) -> None:
        """FSDP, after the backward: the mean gradient of each split
        parameter's shard into the shard's ``.grad`` (one reduce-scatter),
        of each whole one in place (one all-reduce); the whole copies
        freed."""
        parts = C.reduce_scatter_shards(
            [self.params[i].grad for i in self._split],
            [self.dims[i] for i in self._split])
        for i, g in zip(self._split, parts):
            self.shards[i].grad = g
        C.all_reduce_mean_([self.params[i].grad for i in self._whole])
        self.release()

    def shard_grads(self) -> None:
        """ZeRO-1: each shard's ``.grad``, the view of its parameter's
        (mean) gradient."""
        for i in self._split:
            self.shards[i].grad = self.part(self.params[i].grad,
                                            self.dims[i])

    def publish(self) -> None:
        """ZeRO-1, after the optimizer step: every rank's updated shards
        all-gathered into the parameters."""
        whole = C.all_gather_shards([self.shards[i] for i in self._split],
                                    [self.dims[i] for i in self._split])
        for i, w in zip(self._split, whole):
            self.params[i].detach().copy_(w)
            self.shards[i].grad = None

    def reduce_sums(self, rows: torch.Tensor,
                    order: Sequence[int]) -> torch.Tensor:
        """Per-tensor partial sums ``rows [n, k]`` (row j of layout index
        ``order[j]``) summed over the ranks in one all-reduce; the rows of
        whole tensors count rank 0's only."""
        if self.mesh.rank != 0:
            keep = torch.tensor([self.dims[i] is not None for i in order],
                                device=rows.device)
            rows = torch.where(keep[:, None], rows, torch.zeros_like(rows))
        return C.all_reduce_sum(rows)

    def grad_norm(self) -> torch.Tensor:
        """FSDP: the global gradient norm from the shards' squares."""
        sq = torch.stack([s.grad.float().pow(2).sum() for s in self.shards])
        return self.reduce_sums(sq[:, None], range(len(self.shards)))[
            :, 0].sum().sqrt()

    # -- checkpoints ---------------------------------------------------

    def full_params(self) -> Dict[str, torch.Tensor]:
        """Name → whole parameter (FSDP gathers; every rank takes part)."""
        out = {n: p.detach() for n, p in zip(self.names, self.params)}
        if self.fsdp:
            whole = C.all_gather_shards(
                [self.shards[i] for i in self._split],
                [self.dims[i] for i in self._split])
            for i, w in zip(self._split, whole):
                out[self.names[i]] = w
        return out

    @torch.no_grad()
    def load_params(self, state: Mapping[str, torch.Tensor]) -> None:
        """Whole parameters by name into this rank's layout."""
        for i, (n, p) in enumerate(zip(self.names, self.params)):
            if self.fsdp and self.dims[i] is not None:
                self.shards[i].copy_(self.part(state[n], self.dims[i]))
            else:
                p.copy_(state[n])

    def _state_dims(self, sd: dict, order: Sequence[int]):
        """(key of ``sd["state"]``, entry, dim) of every split tensor."""
        for k, st in sd["state"].items():
            i = order[int(k)]
            for name, t in st.items():
                if self.dims[i] is not None and torch.is_tensor(t) \
                        and t.dim() > 0:
                    yield k, name, self.dims[i]

    def full_optimizer_state(self, sd: dict, order: Sequence[int]) -> dict:
        """An optimizer ``state_dict`` over the shards (state index j of
        layout index ``order[j]``) with every split tensor gathered whole:
        the replicated layout's format."""
        keys = list(self._state_dims(sd, order))
        whole = C.all_gather_shards([sd["state"][k][n] for k, n, _ in keys],
                                    [d for _, _, d in keys])
        state = {k: dict(st) for k, st in sd["state"].items()}
        for (k, n, _), w in zip(keys, whole):
            state[k][n] = w
        return {**sd, "state": state}

    def shard_optimizer_state(self, sd: dict, order: Sequence[int]) -> dict:
        """The inverse: a whole-tensor ``state_dict`` cut to this rank's
        shards."""
        state = {k: dict(st) for k, st in sd["state"].items()}
        for k, n, d in self._state_dims(sd, order):
            state[k][n] = self.part(state[k][n], d).clone()
        return {**sd, "state": state}


def layout_order(layout: Optional[ShardLayout],
                 optimizer: torch.optim.Optimizer) -> List[int]:
    """The layout index of each of ``optimizer``'s tensors, in its
    ``state_dict`` order (the groups' order)."""
    return [layout.index(p) for g in optimizer.param_groups
            for p in g["params"]]
