"""How much precision the lo halves of the bf16 blockwise backward buy.

    python -m clip_finegrained_alignment_tpu_torch.perf.lo_half_study

Run from the repository root on the card (it needs ``nvcc``). The bf16
kernels of ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkdv.cu`` feed ds
(to dq), p (to dv) and ds (to dk) into their gradient products as bf16
pairs hi + lo. For each of the three, this builds the source once more with
the lo product's line taken out, then holds dq, dk and dv of the kernels as
built and of each variant against the plain backward at the bf16 shapes of
``chip_smoke.py`` phase 7, with its inputs and its tolerance ``BWD_TOL``.
It prints one JSON line a shape, the largest error over the tolerance of
each gradient under each build (at most 1 passes), then the largest over
all shapes.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

from ..ops import _build
from ..ops import flash_attention as fa

# gradient -> (kernel, the source line of the product that adds its lo half)
LO_PRODUCTS = {
    "dq": ("flash_bwd_dq", "wg::mma_ay<DH>(acc, lo[ks], Kt, ks);"),
    "dv": ("flash_bwd_dkdv", "wg::mma_ay<DH>(dvacc, plo[ks], Ot, ks);"),
    "dk": ("flash_bwd_dkdv", "wg::mma_ay<DH>(dkacc, dlo[ks], Qt, ks);"),
}


def without_line(name: str, line: str) -> str:
    """The source of kernel ``name`` with the one line holding ``line``
    taken out."""
    lines = (_build.CSRC / _build.SOURCES[name]).read_text().splitlines(True)
    hits = [i for i, text in enumerate(lines) if line in text]
    if len(hits) != 1:
        raise ValueError(f"{line!r} is on {len(hits)} lines of {name}")
    del lines[hits[0]]
    return "".join(lines)


def build(name: str, source: str, where: Path) -> ctypes.CDLL:
    """``source`` in place of kernel ``name``'s, beside a copy of the
    shared headers, built as ``_build`` builds it; nvcc's output goes to
    ``_build.build_logs`` under the library's path."""
    shutil.copytree(_build.CSRC, where)
    path = where / _build.SOURCES[name]
    path.write_text(source)
    out = where / "variant.so"
    done = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(path)], check=True,
                          capture_output=True, text=True)
    _build.build_logs[str(out)] = done.stdout + done.stderr
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def loaded(name: str, lib: Optional[ctypes.CDLL]):
    """Kernel ``name``'s wrapper launches from ``lib`` (None: as built)."""
    built = _build.load(name)
    _build._libs[name] = lib or built
    try:
        yield
    finally:
        _build._libs[name] = built


def main() -> Dict[str, Dict[str, float]]:
    import chip_smoke as smoke

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the study runs the kernels")
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        _build.load(name)
    tmp = Path(tempfile.mkdtemp())
    builds = [("as built", "flash_bwd_dq", None)] + [
        (f"no lo in {grad}", name,
         build(name, without_line(name, line), tmp / grad))
        for grad, (name, line) in LO_PRODUCTS.items()]
    worst: Dict[str, Dict[str, float]] = {}
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 4)
    for what, B, H, S, D, bias_kind in smoke.LONG_SHAPES:
        q, k, v, do, bias = smoke.long_inputs(gen, B, H, S, D, torch.bfloat16,
                                              bias_kind)
        scale = D ** -0.5
        o, lse = fa.blockwise_attention_reference(q, k, v, bias, scale,
                                                  smoke.LONG_BLOCK)
        delta = fa._delta(do, o)
        ref = fa.blockwise_attention_backward_reference(q, k, v, bias, scale,
                                                        o, lse, do)
        row = {"shape": what}
        for build_name, name, lib in builds:
            with loaded(name, lib):
                dq = fa._launch_bwd_dq(q, k, v, bias, scale, do, lse, delta)
                dk, dv = fa._launch_bwd_dkdv(q, k, v, bias, scale, do, lse,
                                             delta)
                torch.cuda.synchronize()
            row[build_name] = {
                g: smoke.bwd_excess(got, want, "bfloat16")
                for g, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
            top = worst.setdefault(build_name, {})
            for g, x in row[build_name].items():
                top[g] = max(top.get(g, 0.0), x)
        print(json.dumps(row), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"largest over the shapes": worst}), flush=True)
    return worst


if __name__ == "__main__":
    main()
