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
branch is a ``torch.where`` on a device scalar: no host sync.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


class AdamSPD(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 amsgrad: bool = False,
                 anchors: Optional[Iterable[torch.Tensor]] = None):
        """``anchors``: the pretrained values to decay toward, one per
        parameter in ``params`` order; None takes the parameters' values
        now."""
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      amsgrad=amsgrad))
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
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
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
                new_p = p - float(np.float32(lr) / bc1) * m / denom
                pre = st["anchor"]
                condition = -(g * (p - pre)).sum()
                curr = (new_p - pre).pow(2).sum().sqrt()
                prev = (p - pre).pow(2).sum().sqrt()
                safe = torch.where(curr == 0, torch.ones_like(curr), curr)
                ratio = torch.where(curr == 0, torch.zeros_like(curr),
                                    (curr - prev) / safe).clamp(0.0, 1.0)
                projected = new_p - wd * ratio * (new_p - pre)
                p.copy_(torch.where(condition < 0, projected, new_p))
