"""ZeRO-1 and FSDP over the data ranks, on top of the tensor- and
pipeline-parallel base layout: which parameters are split along which
dim (``sharding_rules.py``), this rank's parts of them ("shards"), the
collectives that move between whole tensors and parts
(``collectives.py``), and the sums that count every tensor once. The port
of what GSPMD does from the JAX package's ``zero1_opt_shardings``,
``fsdp_param_shardings`` and ``composed_param_shardings``.

A rank's model holds its tensor-parallel shards and its pipeline stage's
layers (``models/clip.py``): those are its parameters here. On them:

* **ZeRO-1.** Parameters and gradients stay whole over the data ranks;
  the optimizer steps this rank's data shard of each parameter, a view
  into the parameter, so its moments and anchors are 1/D of the
  replicated ones. After the step every data rank's updated shards are
  all-gathered into the parameters (:meth:`ShardLayout.publish`).
* **FSDP.** Between steps a rank keeps only its data shards, standalone
  tensors, and the model's split parameters hold no storage. A step
  gathers the parameters into the model (:meth:`ShardLayout.gather_params`),
  runs forward and backward, reduce-scatters the gradients into the
  shards' ``.grad`` (mean over the data ranks) and frees the gathered
  copies (:meth:`ShardLayout.reduce_grads`). The whole model is gathered
  at the step's start; gathering layer by layer is a later perf PR.
* **Neither** (tensor, pipeline or sequence parallelism alone): every
  data dim is None; the layout still counts the sums and gathers the
  checkpoints.

Under sequence parallelism the model axis splits tokens, not parameters:
every tensor is whole on every model rank (a copy over ``model``), its
gradient the same there once the train step has summed the model ranks'
parts (``parallel/sequence.py``), and ZeRO-1 and FSDP shard over the data
ranks alone, with JAX's ``megatron_base=False`` choice of dim.

A tensor the data rule leaves whole is its own shard on every data rank:
every rank updates it the same way from the same mean gradient.

Sums over a tensor's parts (AdamSPD's per-tensor sums, the global
gradient norm) go through :meth:`ShardLayout.reduce_rows`: each rank
writes its rows into a buffer indexed by the *whole* model's tensors, one
all-reduce over every rank adds them, and a rank reads its own rows back.
A row counts on this rank only where this rank holds a distinct part: a
data shard, a tensor-parallel shard or its stage's layer; a tensor
replicated over an axis counts on that axis's rank 0 alone. So a
tensor-parallel shard's sums add up to the whole tensor's, a LayerNorm or
a row-parallel bias (equal on every model rank) counts once, and the
parameters after the pipeline (equal on every stage) count once.

Checkpoints hold whole tensors in the replicated layout's format:
:meth:`full_params` and :meth:`full_optimizer_state` gather the data
shards, :meth:`whole_tensors` and :meth:`whole_optimizer_state` the
tensor-parallel shards and the stages (every rank takes part);
:meth:`load_params`, :meth:`local_optimizer_state` and
:meth:`shard_optimizer_state` cut them again, at any layout and rank
count.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..ops import optimizer as optimizer_ops
from . import collectives as C
from .mesh import Mesh
from .sharding_rules import data_shard_dim, layer_index, tp_dim

_LAYERS = ".encoder.layers."


def _renumber(name: str, index: int) -> str:
    head, tail = name.split(_LAYERS, 1)
    return f"{head}{_LAYERS}{index}.{tail.split('.', 1)[1]}"


def whole_names(names: Sequence[str], stage: int, stages: int
                ) -> Tuple[List[str], Dict[str, int]]:
    """The whole model's parameter names in its order, from stage
    ``stage``'s (``names``: each tower's layers a contiguous block), and
    the layer count of each tower (its prefix → L)."""
    out, layers, i = [], {}, 0
    while i < len(names):
        if stages == 1 or layer_index(names[i]) is None:
            out.append(names[i])
            if layer_index(names[i]) is not None:
                prefix = names[i].split(_LAYERS, 1)[0]
                layers[prefix] = max(layers.get(prefix, 0),
                                     layer_index(names[i]) + 1)
            i += 1
            continue
        prefix = names[i].split(_LAYERS, 1)[0]
        j = i
        while j < len(names) and names[j].startswith(prefix + _LAYERS):
            j += 1
        block = names[i:j]
        idx = sorted({layer_index(n) for n in block})
        per = len(idx)
        layers[prefix] = per * stages
        for s in range(stages):
            out += [_renumber(n, layer_index(n) - idx[0] + s * per)
                    for n in block]
        i = j
    return out, layers


class ShardLayout:
    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 mesh: Mesh, fsdp: bool, data_sharded: bool = True):
        """``named_params``: this rank's parameters (HF names). ``fsdp``:
        the parameters are split over the data ranks between steps;
        ``data_sharded`` False: nothing is (tensor or pipeline parallelism
        without ZeRO-1 or FSDP)."""
        self.mesh = mesh
        self.fsdp = fsdp
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.tp_dims = [tp_dim(n) if mesh.tensor_parallel else None
                        for n in self.names]
        self.staged = [mesh.pipe > 1 and layer_index(n) is not None
                       for n in self.names]
        dp = mesh.data if (data_sharded or fsdp) else 1
        self.dims = []
        for p, t in zip(self.params, self.tp_dims):
            shape = list(p.shape)
            if t is not None:
                shape[t] *= mesh.model
            self.dims.append(data_shard_dim(tuple(shape), dp, taken=t))
        self.whole, self.layers = whole_names(self.names, mesh.pipe_rank,
                                              mesh.pipe)
        row = {n: i for i, n in enumerate(self.whole)}
        self.rows = [row[n] for n in self.names]
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

    @property
    def model_parallel(self) -> bool:
        """Whether this rank's parameters are a part of the model's
        (tensor or pipeline parallelism; not sequence parallelism)."""
        return self.mesh.tensor_parallel or self.mesh.pipe > 1

    def part(self, x: torch.Tensor, d: int) -> torch.Tensor:
        return C.shard(x, d, self.mesh.data_rank, self.mesh.data)

    def index(self, t: torch.Tensor) -> int:
        """The layout index of shard ``t`` (the optimizer's own tensor)."""
        return self._index[id(t)]

    def _group(self):
        return self.mesh.group("data")

    # -- the step ------------------------------------------------------

    def release(self) -> None:
        """FSDP: drop the whole copies of the split parameters."""
        for i in self._split:
            self.params[i].data = self.params[i].data.new_empty(0)
            self.params[i].grad = None

    def gather_params(self) -> None:
        """FSDP: every data rank's shards gathered into the model."""
        whole = C.all_gather_shards([self.shards[i] for i in self._split],
                                    [self.dims[i] for i in self._split],
                                    self._group())
        for i, w in zip(self._split, whole):
            self.params[i].data = w

    def reduce_grads(self) -> None:
        """FSDP, after the backward: the mean gradient over the data ranks
        of each split parameter's shard into the shard's ``.grad`` (one
        reduce-scatter), of each whole one in place (one all-reduce); the
        gathered copies freed."""
        parts = C.reduce_scatter_shards(
            [self.params[i].grad for i in self._split],
            [self.dims[i] for i in self._split], self._group())
        for i, g in zip(self._split, parts):
            self.shards[i].grad = g
        C.all_reduce_mean_([self.params[i].grad for i in self._whole],
                           self._group())
        self.release()

    def shard_grads(self) -> None:
        """ZeRO-1: each shard's ``.grad``, the view of its parameter's
        (mean) gradient."""
        for i in self._split:
            self.shards[i].grad = self.part(self.params[i].grad,
                                            self.dims[i])

    def publish(self) -> None:
        """ZeRO-1, after the optimizer step: every data rank's updated
        shards all-gathered into the parameters."""
        if not self._split:
            return
        whole = C.all_gather_shards([self.shards[i] for i in self._split],
                                    [self.dims[i] for i in self._split],
                                    self._group())
        for i, w in zip(self._split, whole):
            self.params[i].detach().copy_(w)
            self.shards[i].grad = None

    def counts(self, i: int, split_over_data: bool) -> bool:
        """Whether layout index ``i``'s row counts on this rank (module
        docstring): a distinct part here, or axis rank 0 of a copy."""
        m = self.mesh
        return ((split_over_data and self.dims[i] is not None)
                or m.data_rank == 0) \
            and (self.tp_dims[i] is not None or m.model_rank == 0) \
            and (self.staged[i] or m.pipe_rank == 0)

    def reduce_rows(self, rows: torch.Tensor, order: Sequence[int],
                    split_over_data: bool, every: bool = False
                    ) -> torch.Tensor:
        """Per-tensor partial sums ``rows [n, k]`` (row j of layout index
        ``order[j]``) summed over every rank's parts of the same tensor in
        one all-reduce; each tensor counted once (:meth:`counts`).
        ``split_over_data``: the rows are of data shards (the optimizer's
        tensors, FSDP's gradients), else of tensors whole over the data
        ranks. Returns this rank's rows, or with ``every`` the whole
        model's (other stages' too)."""
        keep = torch.tensor([self.counts(i, split_over_data) for i in order],
                            device=rows.device)
        rows = torch.where(keep[:, None], rows, torch.zeros_like(rows))
        index = torch.tensor([self.rows[i] for i in order],
                             device=rows.device)
        buf = rows.new_zeros((len(self.whole),) + tuple(rows.shape[1:]))
        buf.index_copy_(0, index, rows)
        buf = C.all_reduce_sum(buf)
        return buf if every else buf[index]

    def reduce_sums(self, rows: torch.Tensor,
                    order: Sequence[int]) -> torch.Tensor:
        """AdamSPD's per-tensor sums of the optimizer's tensors (data
        shards under ZeRO-1 and FSDP), whole-tensor sums back."""
        return self.reduce_rows(rows, order, split_over_data=True)

    def grad_norm(self) -> torch.Tensor:
        """The global gradient norm: every tensor's squares counted once
        over the ranks (FSDP: of the shards' mean gradients; else of the
        parameters' whole-over-data ones)."""
        grads = [s.grad for s in self.shards] if self.fsdp else \
            [p.grad for p in self.params]
        sq = optimizer_ops.sumsq_rows(grads)
        return optimizer_ops.norm_of_rows(self.reduce_rows(
            sq[:, None], range(len(grads)), split_over_data=self.fsdp,
            every=True)[:, 0])

    # -- checkpoints ---------------------------------------------------

    def full_params(self) -> Dict[str, torch.Tensor]:
        """Name → parameter whole over the data ranks (FSDP gathers;
        every rank takes part)."""
        out = {n: p.detach() for n, p in zip(self.names, self.params)}
        if self.fsdp:
            whole = C.all_gather_shards(
                [self.shards[i] for i in self._split],
                [self.dims[i] for i in self._split], self._group())
            for i, w in zip(self._split, whole):
                out[self.names[i]] = w
        return out

    def whole_tensors(self, per_param: Sequence[Sequence[torch.Tensor]]
                      ) -> List[List[torch.Tensor]]:
        """For each layout index i, tensors ``per_param[i]`` of parameter
        i's shape (the parameter, its moments, its anchor) put back whole
        over the model ranks and the stages: ``out[row]`` of every whole
        row (``self.whole``'s order), its tensors in the same order. Every
        rank takes part and gets them all."""
        m = self.mesh
        items = [list(ts) for ts in per_param]
        if m.tensor_parallel:
            flat = [(i, j) for i, ts in enumerate(items)
                    for j in range(len(ts)) if self.tp_dims[i] is not None]
            whole = C.all_gather_shards(
                [items[i][j] for i, j in flat],
                [self.tp_dims[i] for i, _ in flat], m.group("model"))
            for (i, j), w in zip(flat, whole):
                items[i][j] = w
        out: List[Optional[List[torch.Tensor]]] = [None] * len(self.whole)
        staged = [i for i in range(len(items)) if self.staged[i]]
        for i in range(len(items)):
            if not self.staged[i]:
                out[self.rows[i]] = items[i]
        if staged:
            by_stage = C.all_gather_shards(
                [t for i in staged for t in items[i]],
                [None] * sum(len(items[i]) for i in staged),
                m.group("pipe"))
            k = 0
            for i in staged:
                n = len(items[i])
                per = self.layers[self.names[i].split(_LAYERS, 1)[0]] \
                    // m.pipe
                li = layer_index(self.names[i])
                for s in range(m.pipe):
                    name = _renumber(self.names[i],
                                     li - m.pipe_rank * per + s * per)
                    out[self.whole.index(name)] = [
                        by_stage[k + j][s] for j in range(n)]
                k += n
        return out

    def local_part(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """Layout index ``i``'s tensor-parallel shard of a whole tensor."""
        d = self.tp_dims[i]
        return whole if d is None else whole.chunk(
            self.mesh.model, d)[self.mesh.model_rank]

    @torch.no_grad()
    def load_params(self, state: Mapping[str, torch.Tensor]) -> None:
        """Whole parameters by name into this rank's layout."""
        for i, (n, p) in enumerate(zip(self.names, self.params)):
            t = self.local_part(i, state[n])
            if self.fsdp and self.dims[i] is not None:
                self.shards[i].copy_(self.part(t, self.dims[i]))
            else:
                p.copy_(t)

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
        layout index ``order[j]``) with every data-split tensor gathered
        whole over the data ranks."""
        keys = list(self._state_dims(sd, order))
        if not keys:
            return sd
        whole = C.all_gather_shards([sd["state"][k][n] for k, n, _ in keys],
                                    [d for _, _, d in keys], self._group())
        state = {k: dict(st) for k, st in sd["state"].items()}
        for (k, n, _), w in zip(keys, whole):
            state[k][n] = w
        return {**sd, "state": state}

    def shard_optimizer_state(self, sd: dict, order: Sequence[int]) -> dict:
        """The inverse: a ``state_dict`` whole over the data ranks cut to
        this rank's data shards."""
        state = {k: dict(st) for k, st in sd["state"].items()}
        for k, n, d in self._state_dims(sd, order):
            state[k][n] = self.part(state[k][n], d).clone()
        return {**sd, "state": state}

    def whole_optimizer_state(self, sd: dict, order: Sequence[int],
                              groups: Sequence[Sequence[str]]) -> dict:
        """A ``state_dict`` of this rank's parameters (whole over the data
        ranks) as the one-process optimizer over the whole model would
        hold it: its tensors gathered over the model ranks and stages,
        keyed by the whole model's index in ``groups`` (the whole
        optimizer's groups, by name, in order). Entries that are not
        tensors of the parameter's shape (the step) are the same for
        every parameter: a stage's copy stands for the others'."""
        by_index = {order[int(k)]: st for k, st in sd["state"].items()}
        keys = sorted({e for st in by_index.values() for e in st
                       if torch.is_tensor(st[e]) and st[e].dim() > 0})
        n = len(self.names)
        tensors = self.whole_tensors(
            [[by_index[i][e] for e in keys if e in by_index.get(i, {})]
             for i in range(n)])
        scalars = {}
        for i in range(n):
            st = by_index.get(i, {})
            scalars[i] = {e: v for e, v in st.items() if e not in keys}
        local_row = {r: i for i, r in enumerate(self.rows)}
        position = {name: k for k, name in enumerate(
            [nm for g in groups for nm in g])}
        state = {}
        for r, name in enumerate(self.whole):
            i = local_row.get(r)
            if i is None:   # another stage's: this stage's counterpart
                i = self._counterpart(name)
            st_keys = [e for e in keys if e in by_index.get(i, {})]
            if not st_keys and not scalars[i]:
                continue
            st = dict(scalars[i])
            st.update(zip(st_keys, tensors[r]))
            state[position[name]] = st
        pgs, k = [], 0
        for g, names in zip(sd["param_groups"], groups):
            pgs.append({**g, "params": list(range(k, k + len(names)))})
            k += len(names)
        return {"state": state, "param_groups": pgs}

    def _counterpart(self, name: str) -> int:
        """This stage's layout index of the parameter at ``name``'s place
        in its own stage (another stage's layer)."""
        prefix = name.split(_LAYERS, 1)[0]
        per = self.layers[prefix] // self.mesh.pipe
        li = layer_index(name) % per + self.mesh.pipe_rank * per
        return self.names.index(_renumber(name, li))

    def local_optimizer_state(self, sd: dict, order: Sequence[int],
                              groups: Sequence[Sequence[str]],
                              local_groups: Sequence[dict]) -> dict:
        """The inverse: a whole model's ``state_dict`` (``groups``: its
        groups' names) cut to this rank's parameters, state index j of
        layout index ``order[j]``, in the groups ``local_groups`` (this
        rank's optimizer's own ``state_dict()["param_groups"]``)."""
        position = {name: k for k, name in enumerate(
            [nm for g in groups for nm in g])}
        state = {}
        for j, i in enumerate(order):
            k = position[self.names[i]]
            st = sd["state"].get(k, sd["state"].get(str(k)))
            if st is not None:
                state[j] = {e: self.local_part(i, v).clone()
                            if torch.is_tensor(v) and v.dim() > 0 else v
                            for e, v in st.items()}
        pgs = [{**g, "params": lg["params"]}
               for g, lg in zip(sd["param_groups"], local_groups)]
        return {"state": state, "param_groups": pgs}


def layout_order(layout: Optional[ShardLayout],
                 optimizer: torch.optim.Optimizer) -> List[int]:
    """The layout index of each of ``optimizer``'s tensors, in its
    ``state_dict`` order (the groups' order)."""
    return [layout.index(p) for g in optimizer.param_groups
            for p in g["params"]]
