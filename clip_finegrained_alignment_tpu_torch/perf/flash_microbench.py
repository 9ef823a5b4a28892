"""Blockwise attention microbenchmark at its design points, on the card.

    python -m clip_finegrained_alignment_tpu_torch.perf.flash_microbench \\
        [--seq 2048] [--batch 4] [--steps 20]

The port of ``perf/flash_microbench.py``: q, k, v ``[B, 12, S, 64]`` bf16
from a numpy generator seeded 0, with B = max(1, 8192 // S) unless given
(the design points are S in {1024, 2048, 4096}). It times the forward and
the forward+backward of ``sum(out.float())`` on two paths:

* ``blockwise``: :func:`ops.flash_attention.blockwise_flash_attention` with
  ``block_q = block_k = 256`` (``csrc/flash_fwd.cu``, ``flash_bwd_dq.cu``,
  ``flash_bwd_dkdv.cu``);
* ``fused``: the model's attention path, :func:`ops.attention.
  flash_attention` (``csrc/attention_fwd.cu``, ``attention_bwd.cu``), fed
  the bhsd tensors as bshd views.

Each time is the mean of ``--steps`` calls between two CUDA events, after
a warm-up call; one line per measurement, ``S=… B=… <path> <fwd|fwd+bwd>:
… ms/call``. The device is cuda: a host without one raises. ``--device
cpu`` runs the plain versions and is for the tests only.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..ops.attention import flash_attention
from ..ops.flash_attention import blockwise_flash_attention
from ._measure import time_ms

H, D = 12, 64
BLOCK = 256


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=None,
                    help="default max(1, 8192 // seq)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the microbenchmark times the "
                           "card (--device cpu is for the tests only)")
    S = args.seq
    B = args.batch or max(1, 8192 // S)
    scale = D ** -0.5
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, S, D)))
               .to(torch.bfloat16).to(device) for _ in range(3))

    paths = {
        "blockwise": lambda q, k, v: blockwise_flash_attention(
            q, k, v, None, scale, block_q=BLOCK, block_k=BLOCK),
        "fused": lambda q, k, v: flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None,
            scale),
    }
    grads_of = [t.detach().requires_grad_() for t in (q, k, v)]
    lines = []
    for name, fn in paths.items():
        runs = {
            "fwd": lambda: fn(q, k, v).float().sum(),
            "fwd+bwd": lambda: torch.autograd.grad(
                fn(*grads_of).float().sum(), grads_of),
        }
        for label, run in runs.items():
            ms = time_ms(run, device, reps=args.steps)
            line = f"S={S} B={B} {name} {label}: {ms:.3f} ms/call"
            print(line, flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
