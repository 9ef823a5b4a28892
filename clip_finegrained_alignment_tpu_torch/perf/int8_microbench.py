"""Int8 against bf16 GEMMs at CLIP's projection shapes, on the card.

    python -m clip_finegrained_alignment_tpu_torch.perf.int8_microbench \\
        [--reps 20] [--json out.json]

The port of ``perf/int8_microbench.py``: one ViT-B/16 vision layer's
projection GEMM set (q, k, v, out [768, 768], fc1 [768, 3072], fc2
[3072, 768]) at the train microbatch's M = 32 x 197 = 6304 rows, bf16
operands from a numpy generator seeded 0, timed as

* ``fwd_bf16``: ``x @ Wᵀ`` (``torch.matmul``, cuBLAS);
* ``fwd_int8``: ``ops/quant.py::int8_matmul`` (``quant_rows`` of x and W,
  ``torch._int_mm``, ``dequant`` to bf16): the real cost, quantize passes
  included;
* ``fwd_int8_static``: operands quantized beforehand, ``_int_mm`` +
  ``dequant`` only;
* ``bwd_none``, ``bwd_switchback``, ``bwd_int8``: forward and backward of
  the set (``linear``'s autograd, or ``quant_matmul`` in each mode) with
  fixed random cotangents (a sum's cotangent would let a library reduce
  the products away).

Each time is the mean of ``--reps`` calls of the whole set between two
CUDA events, after a warm-up call; TFLOP/s counts the set's bf16-equivalent
products (3x for the backward rows). Beside them, each hand-written kernel
alone at the set's operand shapes (x [6304, 768] and [6304, 3072] by rows
and by columns, W by rows and columns, the sums [6304, 768] and [6304,
3072] to bf16) with its bound: its bytes (operand read once, outputs
written once) at 3.35 TB/s, the H100's memory rate. One line a row, and
a JSON object of them all last (also written to ``--json``). The device
is the card; ``--device cpu`` (with small ``--m/--d/--f``) runs the plain
versions and is for the tests only.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import quant as q
from ._measure import time_ms

HBM_BYTES_PER_S = 3.35e12


def kernel_bytes(name: str, R: int, C: int, item: int = 2) -> int:
    """Bytes a pass must move: its operand read once, its outputs written
    once (``item`` bytes an element of the bf16 or fp32 side)."""
    if name == "quant_rows":
        return R * C * (item + 1) + 4 * R
    if name == "quant_cols_t":
        return R * C * item + C * q.round_up(R) + 4 * C
    if name == "dequant":                   # int32 sums + scales -> y, bias
        return R * C * (4 + item) + 4 * (R + C) + item * C
    if name == "absmax_rows":               # the split passes (absmax in,
        return R * C * item + 4 * R         # scales out)
    if name == "absmax_cols":
        return R * C * item + 4 * C
    if name == "quant_rows_given":
        return R * C * (item + 1) + 8 * R
    if name == "quant_cols_t_given":
        return R * C * item + C * q.round_up(R) + 8 * C
    raise ValueError(name)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=32 * 197)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--f", type=int, default=3072)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the microbenchmark times the "
                           "card (--device cpu is for the tests)")
    M, D, F = args.m, args.d, args.f
    shapes = [(D, D)] * 4 + [(F, D), (D, F)]            # W [N, K]
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=torch.bfloat16)

    x1 = t(rng.normal(size=(M, D)))
    x2 = t(rng.normal(size=(M, F)))
    ws = [t(rng.normal(size=s) * s[1] ** -0.5) for s in shapes]
    cots = [t(rng.normal(size=(M, s[0]))) for s in shapes]
    xs = [x1] * 5 + [x2]
    flops = sum(2 * M * n * k for n, k in shapes)
    xq = {id(x): q.quant_rows(x) for x in (x1, x2)}
    wq = [q.quant_rows(w) for w in ws]

    def fwd(mm):
        return lambda: [mm(x, w) for x, w in zip(xs, ws)]

    def static():
        for x, (wqi, sw) in zip(xs, wq):
            xqi, sx = xq[id(x)]
            q.dequant(q.int_mm(xqi, wqi.t()), sx, sw, None, torch.bfloat16)

    def bwd(mode):
        def run():
            leaves = [x.detach().requires_grad_() for x in (x1, x2)]
            wl = [w.detach().requires_grad_() for w in ws]
            ins = [leaves[0]] * 5 + [leaves[1]]
            outs = [x @ w.t() if mode == "none"
                    else q.quant_matmul(x, w, mode) for x, w in zip(ins, wl)]
            torch.autograd.backward(outs, cots)
        return run

    variants = {
        "fwd_bf16": (fwd(lambda x, w: x @ w.t()), 1),
        "fwd_int8": (fwd(lambda x, w: q.int8_matmul(x, w, None,
                                                    torch.bfloat16)), 1),
        "fwd_int8_static": (static, 1),
        "bwd_none": (bwd("none"), 3),
        "bwd_switchback": (bwd("switchback"), 3),
        "bwd_int8": (bwd("int8"), 3),
    }
    out: Dict = {"M": M, "D": D, "F": F, "reps": args.reps,
                 "device": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                 "gemm_set": {}, "kernels": []}
    print(f"int8_microbench M={M} D={D} F={F} reps={args.reps} "
          f"device={out['device']}", flush=True)
    for name, (run, mult) in variants.items():
        ms = time_ms(run, device, reps=args.reps)
        row = {"ms": ms, "tflops_equiv": flops * mult / (ms / 1e3) / 1e12}
        out["gemm_set"][name] = row
        print(f"{name:16s} {ms:8.4f} ms/set  {row['tflops_equiv']:7.1f} "
              "TFLOP/s-equiv", flush=True)

    acc = {n: q.int_mm(xq[id(x1)][0], wq[i][0].t())
           for i, n in ((0, D), (4, F))}
    cases = [("quant_rows", x1, lambda a=x1: q.quant_rows(a)),
             ("quant_rows", x2, lambda a=x2: q.quant_rows(a)),
             ("quant_rows", ws[4], lambda a=ws[4]: q.quant_rows(a)),
             ("quant_cols_t", x1, lambda a=x1: q.quant_cols_t(a)),
             ("quant_cols_t", x2, lambda a=x2: q.quant_cols_t(a)),
             ("quant_cols_t", ws[4], lambda a=ws[4]: q.quant_cols_t(a))]
    for n, sums in acc.items():
        s_row, s_col = xq[id(x1)][1], torch.ones(n, device=device)
        bias = torch.zeros(n, device=device, dtype=torch.bfloat16)
        cases.append(("dequant", sums, lambda a=sums, sr=s_row, sc=s_col,
                      b=bias: q.dequant(a, sr, sc, b, torch.bfloat16)))
    for name, operand, run in cases:
        R, C = operand.shape
        ms = time_ms(run, device, reps=args.reps)
        nbytes = kernel_bytes(name, R, C)
        row = {"kernel": name, "R": R, "C": C, "ms": ms, "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        out["kernels"].append(row)
        print(f"{name:14s} [{R}, {C}] {ms:8.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB)", flush=True)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
