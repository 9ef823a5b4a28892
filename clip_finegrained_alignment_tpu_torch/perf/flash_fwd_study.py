"""Design variants of the bf16 blockwise forward, timed against each other.

    python -m clip_finegrained_alignment_tpu_torch.perf.flash_fwd_study

Run from the repository root on the card (it needs ``nvcc``). The bf16
kernel of ``csrc/flash_fwd.cu`` takes its shape from constants at the top
of its section: ``kConsumers`` (warpgroups a block, 64 query rows each,
sharing one k/v ring), ``kStages`` (the ring's depth) and ``kMinBlocks``
(the blocks an SM that ``__launch_bounds__`` leaves registers for). For
each variant in :data:`VARIANTS` this builds the source once more with
those constants set, then, at the flash microbenchmark's design points
(``[B, 12, S, 64]`` bf16, S = 1024, 2048, 4096 at B = 8, 4, 1) and with
``chip_smoke.py``'s inputs, holds each build's output to the plain forward
(``BWD_TOL``) and times it in turns, as built first and last (CUDA
events, the median of windows of back-to-back calls), with
``scaled_dot_product_attention`` on the same inputs beside them. It prints
each build's registers and spills, one JSON line a design point, then the
card's name and power limit.
"""

from __future__ import annotations

import json
import re
import shutil
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

from ..ops import _build
from ..ops import flash_attention as fa
from .lo_half_study import build, loaded

NAME = "flash_fwd"
# variant -> the constants of flash_fwd.cu's bf16 section it sets
VARIANTS: Dict[str, Dict[str, int]] = {
    "1 consumer warpgroup": {"kConsumers": 1, "kMinBlocks": 3},
    "2-stage ring": {"kStages": 2},
    "4-stage ring": {"kStages": 4},
}
POINTS = ((1024, 8), (2048, 4), (4096, 1))


def with_constants(values: Dict[str, int]) -> str:
    """flash_fwd.cu with each ``constexpr int <name> = <n>;`` of ``values``
    set to its value; each must be on exactly one line."""
    source = (_build.CSRC / _build.SOURCES[NAME]).read_text()
    for const, value in values.items():
        source, n = re.subn(rf"constexpr int {const} = \d+;",
                            f"constexpr int {const} = {value};", source)
        if n != 1:
            raise ValueError(f"{const} is set on {n} lines of {NAME}")
    return source


def main() -> List[dict]:
    import chip_smoke as smoke

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the study runs the kernels")
    _build.load(NAME)
    tmp = Path(tempfile.mkdtemp())
    builds = [("as built", None)] + [
        (variant, build(NAME, with_constants(values), tmp / str(i)))
        for i, (variant, values) in enumerate(VARIANTS.items())]
    logs = [_build.build_logs.get(NAME, "")] + [
        _build.build_logs[str(tmp / str(i) / "variant.so")]
        for i in range(len(VARIANTS))]
    for (variant, _), text in zip(builds, logs):
        report = {k: r for k, r in smoke.ptxas_report(text).items()
                  if k.startswith("flash_fwd_wgmma")}
        print(json.dumps({"build": variant, "ptxas": report}), flush=True)
    order = builds + builds[::-1]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 4)
    rows = []
    for S, B in POINTS:
        q, k, v, _, _ = smoke.long_inputs(gen, B, 12, S, smoke.LONG_D,
                                          torch.bfloat16, None)
        scale = smoke.LONG_D ** -0.5
        ref, _ = fa.blockwise_attention_reference(q, k, v, None, scale,
                                                  smoke.LONG_BLOCK)
        row = {"S": S, "B": B, "err_over_tol": {}, "ms": {}}
        for name, lib in builds:
            with loaded(NAME, lib):
                o, _ = fa._launch_fwd(q, k, v, None, scale, smoke.LONG_BLOCK)
                torch.cuda.synchronize()
            row["err_over_tol"][name] = smoke.bwd_excess(o, ref, "bfloat16")
        times: Dict[str, List[float]] = {}
        for name, lib in order:
            with loaded(NAME, lib):
                times.setdefault(name, []).append(smoke.cuda_time_ms(
                    lambda: fa._launch_fwd(q, k, v, None, scale,
                                           smoke.LONG_BLOCK)))
        row["ms"] = {name: sum(t) / len(t) for name, t in times.items()}
        row["ms_each"] = times
        row["library_ms"] = smoke.cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale))
        flops = 4.0 * B * 12 * S * S * smoke.LONG_D
        row["tflops"] = {name: flops / (ms * 1e9)
                         for name, ms in row["ms"].items()}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, ref
    shutil.rmtree(tmp, ignore_errors=True)
    print(smoke.gpu_line(), flush=True)
    return rows


if __name__ == "__main__":
    main()
