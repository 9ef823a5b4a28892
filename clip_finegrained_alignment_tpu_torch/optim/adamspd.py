"""Adam with Selective Projection Decay (AdamSPD) as a
``torch.optim.Optimizer``, the port of
``clip_finegrained_alignment_tpu/optim/adamspd.py`` (arXiv:2411.01713).

An Adam step, then, for each parameter tensor whose gradient points away
from its anchor (``−⟨g, p − pre⟩ < 0``), a projection of the new value
back toward the anchor by ``weight_decay · ratio``, where
``ratio = clip((‖new − pre‖ − ‖p − pre‖) / ‖new − pre‖, 0, 1)`` and
``ratio = 0`` when ``new == pre`` (the JAX package's guard of the
reference's division by zero). The condition and the ratio are per torch
tensor, which is per layer: the JAX package reduces its stacked ``[L, …]``
leaves per layer to the same effect.

The anchors live in the optimizer state. A parameter whose ``.grad`` is
None is updated with a zero gradient, as optax updates every leaf. The
branch is taken on the device: no host sync. The step takes two passes
over all the tensors at once (``ops/optimizer.py``: two kernels each on
the card, the per-tensor loops on the CPU): the Adam update and each
tensor's three sums, then the projection, so that under ZeRO-1 and FSDP
the sums of a tensor's shards are added over the ranks in between
(``reduce_sums``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from ..ops import optimizer as ops


class AdamSPD(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False,
                 anchors: Optional[Iterable[torch.Tensor]] = None,
                 reduce_sums: Optional[
                     Callable[[torch.Tensor], torch.Tensor]] = None):
        """``anchors``: the pretrained values to decay toward, one per
        parameter in ``params`` order; None takes the parameters' values
        now. ``reduce_sums``: under ZeRO-1 and FSDP the tensors are shards
        and their sums partial; it maps the step's ``[n_tensors, 3]`` fp32
        sums (rows in ``params`` order) to the whole tensors' sums, one
        all-reduce a step (``parallel/zero.py``)."""
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      amsgrad=amsgrad))
        self.reduce_sums = reduce_sums
        params = [p for g in self.param_groups for p in g["params"]]
        anchors = params if anchors is None else list(anchors)
        if len(anchors) != len(params):
            raise ValueError(f"{len(anchors)} anchors for {len(params)} "
                             "parameters")
        for p, a in zip(params, anchors):
            if a.shape != p.shape:
                raise ValueError(f"anchor shape {tuple(a.shape)} != "
                                 f"parameter shape {tuple(p.shape)}")
            self.state[p]["anchor"] = a.detach().to(
                device=p.device, dtype=p.dtype, copy=True)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamSPD takes no closure")
        params, grads, ms, vs, maxes, anchors, hypers, wds = (
            [] for _ in range(8))
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                st = self.state[p]
                if "step" not in st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                    if group["amsgrad"]:
                        st["max_exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                params.append(p)
                grads.append(p.grad)
                ms.append(st["exp_avg"])
                vs.append(st["exp_avg_sq"])
                maxes.append(st["max_exp_avg_sq"] if group["amsgrad"]
                             else None)
                anchors.append(st["anchor"])
                hypers.append(ops.adam_hyper(group["lr"], b1, b2,
                                             group["eps"], st["step"]))
                wds.append(group["weight_decay"])
        if not params:
            return
        # Pass 1: the Adam update in place, and each tensor's sums
        # [−Σ g·(p − pre), Σ(new − pre)², Σ(p − pre)²].
        sums = ops.adamspd_update(params, grads, ms, vs, maxes, anchors,
                                  hypers)
        if self.reduce_sums is not None:
            sums = self.reduce_sums(sums)
        # Pass 2: the projection of the tensors whose gradient points away
        # from their anchor.
        ops.adamspd_project(params, anchors, sums, wds)
