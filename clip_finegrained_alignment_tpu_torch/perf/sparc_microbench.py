"""The SPARC local-alignment op alone, the port of
``perf/sparc_microbench.py``: kernels #3 and #4 against the plain chain.

The op (the reference's ``finetune/losses.py:221-245``): normalize,
similarity, masked min-max, threshold, renormalize, grouped pooling, at
the train shape of ViT-B/16 (P=196 patches, T=77 tokens, D=512, threshold
0.5, captions masked from token 60 on), fp32, inputs from
``default_rng(0)`` (:func:`inputs`). Two paths:

* ``kernel``: ``ops/sparc_kernel.py::fused_sparc_pooling``, which
  launches ``csrc/sparc_fwd.cu`` and, in the backward,
  ``csrc/sparc_bwd.cu``;
* ``plain``: autograd through ``sparc_pooling_reference``, the port of
  JAX's ``_reference_chain``.

Two modes each: ``fwd`` (the op and a sum) and ``fwd+bwd`` (the sum's
gradient in both inputs). Each is one warm-up call, then the mean of
``iters`` back-to-back calls between two CUDA events.

    python -m clip_finegrained_alignment_tpu_torch.perf.sparc_microbench \\
        [B] [iters]

Defaults: B=256, 50 iterations. One JSON line per path × mode with
``sparc_microbench.py``'s keys (``op``, ``path``, ``mode``, ``batch``,
``ms``, ``pairs_per_sec``), ``device`` and ``gpu`` (the card's name and
power limit); the kernel's lines also carry ``max_abs_err``, its largest
distance from the plain path's output (``fwd``) or gradients
(``fwd+bwd``) on the same inputs. ``--device cpu`` is for the tests
(both paths run the plain chain there, on the host clock).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..models.clip import resolve_device
from ._measure import device_fields, time_ms

P, T, D = 196, 77, 512
THRESHOLD = 0.5


def inputs(B: int, P: int = P, T: int = T, D: int = D,
           seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``sparc_microbench.py``'s draws: v [B, P, D], l [B, T, D] normal
    fp32, the mask [B, T] zero from token 60 on."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, P, D)).astype(np.float32)
    l = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[:, 60:] = 0.0
    return v, l, mask


def paths(mask, threshold: float = THRESHOLD) -> Dict[str, Callable]:
    """``kernel`` and ``plain``: (v, l) → [B, T, D]."""
    from ..ops import sparc_kernel as sk
    return {"kernel": lambda v, l: sk.fused_sparc_pooling(v, l, mask,
                                                          threshold),
            "plain": lambda v, l: sk.sparc_pooling_reference(v, l, mask,
                                                             threshold)}


def modes(fn: Callable) -> Dict[str, Callable]:
    """``fwd``: the op's sum; ``fwd+bwd``: the sum's gradients in v, l."""
    import torch

    def grads(v, l):
        v, l = v.detach().requires_grad_(), l.detach().requires_grad_()
        return torch.autograd.grad(fn(v, l).sum(), (v, l))
    return {"fwd": lambda v, l: (fn(v, l).sum(),), "fwd+bwd": grads}


def run(B: int = 256, iters: int = 50, device="cuda") -> List[dict]:
    """Every path × mode's line (module docstring)."""
    import torch
    device = resolve_device(device)
    v, l, mask = (torch.from_numpy(x).to(device) for x in inputs(B))
    card = device_fields(device)
    fns = paths(mask)
    lines, outs = [], {}
    for name, fn in fns.items():
        for mode, f in modes(fn).items():
            ms = time_ms(lambda: outs.__setitem__((name, mode), f(v, l)),
                         device, reps=iters)
            lines.append({"op": "sparc_local_alignment", "path": name,
                          "mode": mode, "batch": B, "ms": ms,
                          "pairs_per_sec": B / ms * 1e3, **card})
    # The kernel against plain: the forward's output itself (not its sum),
    # and the gradients.
    with torch.no_grad():
        errs = {"fwd": (fns["kernel"](v, l) - fns["plain"](v, l)).abs().max()}
    errs["fwd+bwd"] = max((a - b).abs().max() for a, b in zip(
        outs[("kernel", "fwd+bwd")], outs[("plain", "fwd+bwd")]))
    for line in lines:
        if line["path"] == "kernel":
            line["max_abs_err"] = errs[line["mode"]].item()
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("iters", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.batch, args.iters, args.device)


if __name__ == "__main__":
    main()
