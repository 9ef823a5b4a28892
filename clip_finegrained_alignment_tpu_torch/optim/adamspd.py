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
branch is a ``torch.where`` on a device scalar: no host sync. The step
takes two passes: the Adam update and each tensor's three sums, then the
projection, so that under ZeRO-1 and FSDP the sums of a tensor's shards
are added over the ranks in between (``reduce_sums``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch


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
        # Pass 1: the Adam update in place, and each tensor's sums
        # [−Σ g·(p − pre), Σ(new − pre)², Σ(p − pre)²].
        todo, rows = [], []
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, lr = group["eps"], group["lr"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                if "step" not in st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                    if group["amsgrad"]:
                        st["max_exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                # Bias corrections in fp32, as the JAX package takes them.
                count = np.float32(st["step"])
                bc1 = np.float32(1.0) - np.float32(b1) ** count
                bc2 = np.float32(1.0) - np.float32(b2) ** count
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(g * g, alpha=1 - b2)
                if group["amsgrad"]:
                    torch.maximum(st["max_exp_avg_sq"], v,
                                  out=st["max_exp_avg_sq"])
                    v = st["max_exp_avg_sq"]
                denom = v.sqrt() / float(np.sqrt(bc2)) + eps
                pre = st["anchor"]
                condition = -(g * (p - pre)).sum()
                prev_sq = (p - pre).pow(2).sum()
                p.copy_(p - float(np.float32(lr) / bc1) * m / denom)
                rows.append(torch.stack([condition, (p - pre).pow(2).sum(),
                                         prev_sq]))
                todo.append((p, pre, group["weight_decay"]))
        if not todo:
            return
        sums = torch.stack(rows)
        if self.reduce_sums is not None:
            sums = self.reduce_sums(sums)
        # Pass 2: the projection of the tensors whose gradient points away
        # from their anchor.
        for (p, pre, wd), (condition, curr_sq, prev_sq) in zip(
                todo, sums.unbind(0)):
            curr, prev = curr_sq.sqrt(), prev_sq.sqrt()
            safe = torch.where(curr == 0, torch.ones_like(curr), curr)
            ratio = torch.where(curr == 0, torch.zeros_like(curr),
                                (curr - prev) / safe).clamp(0.0, 1.0)
            projected = p - wd * ratio * (p - pre)
            p.copy_(torch.where(condition < 0, projected, p))
