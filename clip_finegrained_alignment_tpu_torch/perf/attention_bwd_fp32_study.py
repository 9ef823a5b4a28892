"""Design variants of the float32 attention backward, timed against each
other.

    python -m clip_finegrained_alignment_tpu_torch.perf.attention_bwd_fp32_study

Run from the repository root on the card (it needs ``nvcc``). The float32
kernels of ``csrc/attention_bwd.cu`` (the dq and the dk/dv pass) take
their shape from constants at the top of their section: ``kF32Warps``
(warps a block, 16 rows of the block's own tiles each), ``kF32Rows``
(rows of a streamed tile), ``kF32Products`` (TF32 products an fp32 one),
``kF32MinBlocks`` and ``kF32DkdvMinBlocks`` (blocks an SM that
``__launch_bounds__`` leaves registers for in the dq and the dk/dv pass).
For each variant in :data:`VARIANTS` this builds the
source once more with those constants set, all builds at once; with
``--baseline`` also other ``attention_bwd.cu`` files (say, an earlier
commit's, saved beside the repository, built against this tree's
headers). At the train path's shapes (``chip_smoke.py``'s backward rows:
ViT-B/16 vision and the causal text tower at B=32, the count loss's
counterfactual text tower at B=288), fed the forward kernel's lse pair,
it calls each build's float32 C entry alike (:func:`run`), holds its
gradients to the plain backward (``BWD_TOL["float32"]``, at most 1
passes) and times the builds in turns, as built first and last (CUDA
events, the median of windows of back-to-back calls), with the backward
alone of ``scaled_dot_product_attention`` and the bounds beside them. It
prints each build's registers, spills, machine instructions and TF32
``HMMA`` among them, one JSON line a shape, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..ops import _build
from ..ops import attention as ta
from .attention_fp32_study import with_constants
from .lo_half_study import build
from .sparc_study import sass_mix

NAME = "attention_bwd"
# variant -> the constants of attention_bwd.cu's float32 section it sets
VARIANTS: Dict[str, Dict[str, int]] = {
    "hi·hi only (plain TF32, off tolerance)": {"kF32Products": 1},
    "4 products (lo·lo too)": {"kF32Products": 4},
    "dk/dv three blocks an SM (spills)": {"kF32DkdvMinBlocks": 3},
    "dq three blocks an SM (spills)": {"kF32MinBlocks": 3},
    "8 warps, one block an SM": {"kF32Warps": 8, "kF32MinBlocks": 1,
                                 "kF32DkdvMinBlocks": 1},
    "32-row tiles": {"kF32Rows": 32},
}
SHAPES = [  # (what, B, S, H, causal)
    ("vision", 32, 197, 12, False),
    ("text causal", 32, 77, 8, True),
    ("counterfactual text causal", 288, 77, 8, True),
]


def run(lib, q, k, v, bias, scale, do, lse):
    """(dq, dk, dv) of the float32 C entry of ``lib`` (contiguous bshd q,
    k, v, do; the forward's lse pair), with 3·B·H·S floats of scratch: as
    much as any version of ``cfa_attention_bwd`` takes (an earlier
    CUDA-core version writes three row statistics, the 3xTF32 kernels
    one)."""
    B, S, H, D = q.shape
    fn = lib.cfa_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 13
                   + [ctypes.c_float, ctypes.c_void_p])
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((3, B, H, S), device=q.device)
    bias_ptr, bias_sb, _ = ta._kernel_bias(bias, S)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
             do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), stats.data_ptr(), B, S, H, D, 0,
             *ta._strides(q, k, v, do), bias_sb,
             ta.rounded_scale(scale, q.dtype),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cfa_attention_bwd failed: CUDA error {err}")
    return dq, dk, dv


def main(argv: Optional[List[str]] = None) -> List[dict]:
    import chip_smoke as smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", nargs="*", default=[],
                    help="other attention_bwd.cu files to build and time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the study runs the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load(NAME)
    tmp = Path(tempfile.mkdtemp())
    sources = {variant: with_constants(values, NAME)
               for variant, values in VARIANTS.items()}
    for path in args.baseline:
        sources[f"baseline {path}"] = Path(path).read_text()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda item: build(NAME, item[1], tmp / str(item[0])),
            enumerate(sources.values()))))
    builds = [("as built", _build.load(NAME))] + list(libs.items())
    logs = [_build.build_logs.get(NAME, "")] + [
        _build.build_logs[str(tmp / str(i) / "variant.so")]
        for i in range(len(sources))]
    paths = [_build.library_path(NAME)] + [
        tmp / str(i) / "variant.so" for i in range(len(sources))]

    def fp32(report):
        return {k: r for k, r in report.items() if "_mma<" not in k}

    for (variant, _), text, path in zip(builds, logs, paths):
        print(json.dumps({"build": variant,
                          "ptxas": fp32(smoke.ptxas_report(text)),
                          "sass": fp32(sass_mix(path))}), flush=True)
    order = builds + builds[::-1]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 10)
    rows = []
    for what, B, S, H, causal in SHAPES:
        D = 64
        x = torch.randn(B, S, 3 * H * D, device="cuda", generator=gen)
        q, k, v = (x[..., i * H * D:(i + 1) * H * D].contiguous()
                   .view(B, S, H, D) for i in range(3))
        do = torch.randn(B, S, H, D, device="cuda", generator=gen)
        bias = (torch.full((S, S), ta.NEG, device="cuda").triu(1)[None, None]
                if causal else None)
        scale = D ** -0.5
        lse = ta._launch(q, k, v, bias, scale, True)[1]
        ref = ta.attention_backward_reference(q, k, v, bias, scale, do)
        row = {"shape": what, "B": B, "S": S, "H": H, "Dh": D,
               "err_over_tol": {}, "ms": {}}
        for name, lib in builds:
            got = run(lib, q, k, v, bias, scale, do, lse)
            torch.cuda.synchronize()
            row["err_over_tol"][name] = max(
                smoke.bwd_excess(a, b, "float32") for a, b in zip(got, ref))
        times: Dict[str, List[float]] = {}
        for name, lib in order:
            times.setdefault(name, []).append(smoke.cuda_time_ms(
                lambda: run(lib, q, k, v, bias, scale, do, lse)))
        row["ms"] = {name: sum(t) / len(t) for name, t in times.items()}
        row["ms_each"] = times
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias, scale=scale)
        row["library_ms"] = smoke.cuda_time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        row.update(smoke.fused_attention_bound_ms(
            B, S, H, D, "float32", causal, tensors=7, products=5))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, q, k, v, do, ref, out
    shutil.rmtree(tmp, ignore_errors=True)
    print(smoke.gpu_line(), flush=True)
    return rows


if __name__ == "__main__":
    main()
