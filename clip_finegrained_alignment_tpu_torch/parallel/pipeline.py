"""GPipe pipeline parallelism over the encoder layers: the port of
``clip_finegrained_alignment_tpu/parallel/pipeline.py``.

Stage ``s`` of ``K`` (the ``pipe`` coordinate, ``parallel/mesh.py``)
holds encoder layers ``[s·L/K, (s+1)·L/K)`` of both towers
(``models/clip.py`` builds only those). The embeddings, final
LayerNorms, pooling, projections and the loss are whole on every stage,
as in JAX (``pipeline.py:26-29``): every stage runs them on the same
outputs and computes the same loss.

The schedule (:class:`GPipe`), for each encoder call of a forward:

* the call's rows are split into ``M`` pipeline microbatches
  (:func:`default_num_micro`); a per-sample bias ``[B, 1, S, S]`` is
  split with its rows, a broadcast ``[1, …]`` bias is not;
* all M forwards run through the stages: stage 0 takes microbatch j from
  the embeddings, stage s > 0 receives it from stage s − 1
  (``collectives.broadcast_from`` in the two-rank group of the hop), runs
  its layers and hands the result on;
* the last stage's outputs reach every stage (a broadcast over the pipe
  group: JAX's masked ``psum``), where they leave autograd as a leaf;
* after the loss's backward (:meth:`GPipe.backward`, called by the train
  step on every stage), the calls are undone in reverse order: the
  cotangent enters once, at the last stage, and all M backwards run in
  reverse, each gradient handed from stage s to s − 1; stage 0 then
  backpropagates the embeddings.

The backward runs in an order of its own, not in the order autograd
would pick, so that every stage meets the hops of every call in the same
sequence. The stage's parameters collect their gradients there; the
embeddings' gradients live on stage 0 alone and are summed over the pipe
group by the train step, while the gradients of the parameters after the
encoders are the same on every stage and are not.

GPipe keeps every microbatch's stage inputs until the backward, the
memory JAX's ``pipeline.py:44-62`` describes; a 1F1B schedule cannot help
a loss that is contrastive over the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

from . import collectives as C


def default_num_micro(num_stages: int, configured: int = 0) -> int:
    """GPipe microbatch count: the configured value, or 2x the stage
    count."""
    return configured if configured > 0 else 2 * num_stages


def validate_pipe_divisibility(model_cfg, mesh_cfg, batch_size: int,
                               num_micro: int = 0) -> None:
    """Raise when the stage count does not divide both towers' layer
    counts, or the microbatch split does not divide the batch
    (``batch_size``: the rows of one train microbatch on one data
    rank)."""
    k = mesh_cfg.pipe
    if k <= 1:
        return
    m = default_num_micro(k, num_micro)
    problems = []
    for tower, n in (("vision", model_cfg.vision.num_layers),
                     ("text", model_cfg.text.num_layers)):
        if n % k != 0:
            problems.append(f"{tower} tower: {n} layers not divisible by "
                            f"pipe={k}")
    if batch_size % m != 0:
        problems.append(f"batch_size {batch_size} not divisible by "
                        f"pipeline_microbatches {m}")
    if problems:
        raise ValueError("pipeline divisibility failures:\n  "
                         + "\n  ".join(problems))


@dataclass
class _Call:
    """One encoder call's forward state, kept for its backward."""
    out: torch.Tensor                       # the leaf every stage returns
    ins: List[torch.Tensor] = field(default_factory=list)   # stage inputs
    outs: List[torch.Tensor] = field(default_factory=list)  # stage outputs
    x: Optional[torch.Tensor] = None        # stage 0: the embeddings


class GPipe:
    """The GPipe schedule of one model on this rank (stage
    ``mesh.pipe_rank`` of ``mesh.pipe``), ``num_micro`` microbatches an
    encoder call."""

    def __init__(self, mesh, num_micro: int):
        self.mesh = mesh
        self.num_micro = num_micro
        self.stage = mesh.pipe_rank
        self.stages = mesh.pipe
        self.calls: List[_Call] = []

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def _neighbour(self, step: int) -> int:
        return self.mesh.global_rank(pipe=self.stage + step)

    def run(self, layers: Callable, x: Optional[torch.Tensor],
            bias: Optional[torch.Tensor], shape: Tuple[int, int, int],
            dtype: torch.dtype, device) -> torch.Tensor:
        """The encoder over ``[B, S, D]`` rows ``shape``: ``layers(h,
        bias)`` runs this stage's layers on one microbatch; ``x`` is the
        embeddings on stage 0 (None elsewhere). Returns the last stage's
        outputs on every stage; under grad, a leaf whose gradient
        :meth:`backward` carries back through the stages."""
        M = self.num_micro
        B = shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by num_micro {M}")
        b = B // M
        grad = torch.is_grad_enabled()
        per_sample = bias is not None and bias.shape[0] == B and B > 1
        call = _Call(out=None, x=x if self.first else None)
        mesh = self.mesh
        for j in range(M):
            if self.first:
                h = x[j * b:(j + 1) * b].detach()
            else:
                h = C.broadcast_from(None, self._neighbour(-1),
                                     mesh.group("hop_prev"),
                                     (b,) + tuple(shape[1:]), dtype, device)
            if grad:
                h.requires_grad_()
            y = layers(h, bias[j * b:(j + 1) * b] if per_sample else bias)
            if not self.last:
                C.broadcast_from(y, mesh.rank, mesh.group("hop_next"))
            if grad:
                call.ins.append(h)
                call.outs.append(y)
            else:
                call.outs.append(y if self.last else None)
        out = torch.cat(call.outs).detach() if self.last else None
        out = C.broadcast_from(out, self.mesh.global_rank(
            pipe=self.stages - 1), mesh.group("pipe"), tuple(shape), dtype,
            device)
        if not grad:
            return out
        call.out = out.requires_grad_()
        self.calls.append(call)
        return call.out

    def backward(self) -> None:
        """Every recorded call's backward through the stages, the last
        call first; then, on stage 0, the embeddings' backward. Every
        stage calls it after the loss's backward."""
        mesh = self.mesh
        pending = []
        for call in reversed(self.calls):
            g = call.out.grad
            if g is None:
                g = torch.zeros_like(call.out)
            M = len(call.outs)
            gx = [None] * M
            for j in reversed(range(M)):
                y = call.outs[j]
                if self.last:
                    gy = g[j * y.shape[0]:(j + 1) * y.shape[0]]
                else:
                    gy = C.broadcast_from(None, self._neighbour(1),
                                          mesh.group("hop_next"),
                                          tuple(y.shape), y.dtype, y.device)
                torch.autograd.backward(y, gy)
                h = call.ins[j]
                hg = h.grad if h.grad is not None else torch.zeros_like(h)
                if self.first:
                    gx[j] = hg
                else:
                    C.broadcast_from(hg, mesh.rank, mesh.group("hop_prev"))
            if self.first and call.x is not None and call.x.requires_grad:
                pending.append((call.x, torch.cat(gx)))
        self.calls.clear()
        if pending:
            torch.autograd.backward([x for x, _ in pending],
                                    [g for _, g in pending])
