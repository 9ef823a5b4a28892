"""Optimizer construction, the port of
``clip_finegrained_alignment_tpu/optim/factory.py``: clip by global norm,
then AdamW (decay masked) or AdamSPD, at a constant learning rate (or,
when asked, optax's linear warmup from 0 over ``warmup_steps``).

* :func:`decay_mask`: decay every parameter but the biases. The reference
  matches ``("ln", "bn", "bias")`` against HF names, where only ``bias``
  ever matches, so LayerNorm scales are decayed; the JAX package keeps that.
* Clipping is optax's ``clip_by_global_norm``: ``g / ‖g‖ · max_norm``
  when ``‖g‖ ≥ max_norm``, else ``g`` (not ``clip_grad_norm_``'s
  ``max / (‖g‖ + 1e-6)``). On the card the norm and the clip are each one
  pass over every gradient (``ops/optimizer.py``).
* Gradients that are None (under SPARC, ``vision_model.post_layernorm``
  and ``logit_scale`` get none) are made zeros before the clip and the
  step: optax decays and moves every leaf, and ``torch.optim.AdamW``
  would skip them.
* optax's AdamW ``p − lr·(m̂ / (√v̂ + eps) + wd·p)`` equals torch's
  ``p·(1 − lr·wd) − lr·m̂ / (√v̂ + eps)``.
* ``ClippedOptimizer.state_dict()`` holds the inner optimizer's state
  (AdamSPD's anchors, moments and step; AdamW's moments and steps) and the
  update count the schedule reads, so a checkpoint resumes the same
  trajectory.
* ZeRO-1, FSDP, tensor and pipeline parallelism
  (``make_optimizer(..., mesh=...)`` with ``cfg.zero1`` or ``cfg.fsdp``,
  or a mesh with ``model`` or ``pipe`` above 1): the inner optimizer
  steps this rank's shards (``parallel/zero.py::ShardLayout``), AdamSPD's
  per-tensor sums are added over every rank's parts of each tensor in one
  all-reduce a step, and so are the gradient norm's squares, each tensor
  counted once (a tensor-parallel shard's parts summed, a tensor
  replicated over model ranks or stages counted on one); the state dict
  is gathered whole (every rank takes part), in the replicated format,
  so a checkpoint restores at any layout and rank count.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..config import TrainConfig
from ..ops import optimizer as ops
from ..utils.logging import span
from .adamspd import AdamSPD


def decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True = apply weight decay: every parameter not named ``*bias``."""
    return {n: "bias" not in n.rsplit(".", 1)[-1] for n in names}


def make_schedule(cfg: TrainConfig, use_warmup: bool = False
                  ) -> Union[float, Callable[[int], float]]:
    """The learning rate: constant by default (the reference defines
    ``warmup_steps`` but builds no scheduler). With ``use_warmup`` and
    ``warmup_steps > 0``, optax's ``linear_schedule(0, lr, warmup_steps)``
    as a function of the update count: lr · min(count, warmup) / warmup."""
    if not use_warmup or cfg.warmup_steps <= 0:
        return cfg.lr

    def schedule(count: int) -> float:
        return cfg.lr * min(max(count, 0), cfg.warmup_steps) \
            / cfg.warmup_steps
    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) in fp32 over all tensors (optax's ``global_norm``): three
    launches over every tensor on the card (``ops/optimizer.py``)."""
    return ops.global_norm(tensors)


class ClippedOptimizer:
    """Clip by global norm, then step the inner optimizer (the optax
    chain of ``make_optimizer``)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 max_grad_norm: float,
                 schedule: Optional[Callable[[int], float]] = None,
                 layout=None, groups=None):
        """``schedule``: the learning rate of update ``count`` (0 for the
        first), set on every group before the update; None keeps the
        groups' own. ``layout``: the ``ShardLayout`` whose shards
        ``optimizer`` steps (ZeRO-1, FSDP, tensor and pipeline
        parallelism), or None; ``groups``: then the whole model's
        optimizer groups, by parameter name (the checkpoints' layout)."""
        self.optimizer = optimizer
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule
        self.layout = layout
        self.groups = groups
        self.count = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip and update; returns the global norm before clipping. Spans
        ``train.optimizer`` with its two parts, ``train.clip`` and
        ``train.update``."""
        with span("train.optimizer"):
            with span("train.clip"):
                norm = self._clip()
            with span("train.update"):
                self._update()
        return norm

    def _clip(self) -> torch.Tensor:
        layout = self.layout
        if layout is not None and layout.fsdp:
            grads = [s.grad for s in layout.shards]
        else:
            params = self.params if layout is None else layout.params
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
        norm = global_norm(grads) if layout is None else layout.grad_norm()
        if self.max_grad_norm and self.max_grad_norm > 0:
            ops.clip_(grads, norm, self.max_grad_norm)
        if layout is not None and not layout.fsdp:
            layout.shard_grads()
        return norm

    def _update(self) -> None:
        layout = self.layout
        if self.schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1
        if layout is not None and not layout.fsdp:
            layout.publish()

    def state_dict(self) -> dict:
        """The inner optimizer's state (whole tensors under a layout) and
        the update count."""
        sd = self.optimizer.state_dict()
        if self.layout is not None:
            sd = self.layout.full_optimizer_state(sd, self._order())
            if self.layout.model_parallel:
                sd = self.layout.whole_optimizer_state(sd, self._order(),
                                                       self.groups)
        return {"optimizer": sd, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` taken from an optimizer of the same
        kind over the same parameters, at any rank count (tensors go to
        the parameters' device)."""
        sd = state["optimizer"]
        if self.layout is not None and self.layout.model_parallel:
            sd = self.layout.local_optimizer_state(
                sd, self._order(), self.groups,
                self.optimizer.state_dict()["param_groups"])
        if self.layout is not None:
            sd = self.layout.shard_optimizer_state(sd, self._order())
        self.optimizer.load_state_dict(sd)
        self.count = int(state["count"])

    def _order(self) -> List[int]:
        from ..parallel.zero import layout_order
        return layout_order(self.layout, self.optimizer)


def make_optimizer(cfg: TrainConfig,
                   named_params: Iterable[Tuple[str, torch.Tensor]],
                   anchors: Optional[Dict[str, torch.Tensor]] = None,
                   use_warmup: bool = False, mesh=None) -> ClippedOptimizer:
    """Clip by ``cfg.max_grad_norm`` (0 = no clip), then AdamSPD (one
    group, anchors = ``anchors`` or the parameters now) or AdamW with
    :func:`decay_mask`, at :func:`make_schedule`'s learning rate. With a
    ``mesh`` and ``cfg.zero1`` or ``cfg.fsdp``, or a ``mesh`` with
    ``model`` or ``pipe`` above 1 (``named_params``: this rank's part of
    the model), it steps this rank's shards (FSDP also releases the
    model's whole parameters); ``anchors`` are whole tensors, cut here."""
    named = [(n, p) for n, p in named_params if p.requires_grad]
    schedule = make_schedule(cfg, use_warmup)
    lr = schedule(0) if callable(schedule) else schedule
    layout = None
    if mesh is not None and (cfg.zero1 or cfg.fsdp or mesh.model > 1
                             or mesh.pipe > 1):
        from ..parallel.zero import ShardLayout
        layout = ShardLayout(named, mesh, fsdp=cfg.fsdp,
                             data_sharded=cfg.zero1 or cfg.fsdp)
        named = list(zip(layout.names, layout.shards))
        if anchors is not None:   # whole tensors: this rank's parts
            anchors = {n: layout.local_part(i, anchors[n]) if d is None
                       else layout.part(layout.local_part(i, anchors[n]), d)
                       for i, (n, d) in enumerate(zip(layout.names,
                                                      layout.dims))}
    if cfg.optimizer_type == "adamspd":
        order = list(range(len(named)))
        opt = AdamSPD([p for _, p in named], lr=lr, betas=cfg.betas,
                      eps=cfg.eps, weight_decay=cfg.weight_decay,
                      amsgrad=cfg.amsgrad,
                      anchors=None if anchors is None
                      else [anchors[n] for n, _ in named],
                      reduce_sums=None if layout is None
                      else lambda rows: layout.reduce_sums(rows, order))
    else:
        mask = decay_mask(n for n, _ in named)
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0}]
        opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=lr,
                                betas=cfg.betas, eps=cfg.eps)
    whole = None
    if layout is not None and layout.model_parallel:
        # The whole model's groups by name, as one process would make them.
        if cfg.optimizer_type == "adamspd":
            whole = [layout.whole]
        else:
            mask = decay_mask(layout.whole)
            whole = [g for g in ([n for n in layout.whole if mask[n]],
                                 [n for n in layout.whole if not mask[n]])
                     if g]
    return ClippedOptimizer(opt, cfg.max_grad_norm,
                            schedule if callable(schedule) else None,
                            layout=layout, groups=whole)
