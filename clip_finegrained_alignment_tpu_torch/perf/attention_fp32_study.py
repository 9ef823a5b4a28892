"""Design variants of the float32 attention forward, timed against each
other.

    python -m clip_finegrained_alignment_tpu_torch.perf.attention_fp32_study \\
        [--baseline path/to/attention_fwd.cu]

Run from the repository root on the card (it needs ``nvcc``). The float32
kernel of ``csrc/attention_fwd.cu`` takes its shape from constants at the
top of its section: ``kF32Keys`` (keys a tile, one step of the softmax
and products), ``kF32Warps`` (warps a block, 16 query rows each),
``kF32Products`` (TF32 products an fp32 one) and ``kF32MinBlocks`` (blocks
an SM that ``__launch_bounds__`` leaves registers for). For each variant
in :data:`VARIANTS` this builds the source once more with those constants
set, all builds at once; with ``--baseline`` also other
``attention_fwd.cu`` files (say, an earlier commit's, saved beside the
repository), built against this tree's headers. At evaluation's shapes
and the serving bucket's, with ``chip_smoke.py``'s bshd inputs, it holds
each build's output to the plain version (``KERNEL_TOL["float32"]``) and
times it in turns, as built first and last (CUDA events, the median of
windows of back-to-back calls), with ``scaled_dot_product_attention`` on
the same inputs and the bounds beside them. It prints each build's
registers, spills, machine instructions and TF32 ``HMMA`` among them, one
JSON line a shape, the rate of ``mma.sync.m16n8k8`` TF32 alone on the card
(:data:`CEILING_SOURCE`: independent products from registers, no loads,
as many warps as fit), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..ops import _build
from ..ops import attention as ta
from .lo_half_study import build, loaded
from .sparc_study import sass_mix

NAME = "attention_fwd"
# variant -> the constants of attention_fwd.cu's float32 section it sets
VARIANTS: Dict[str, Dict[str, int]] = {
    "hi·hi only (plain TF32, off tolerance)": {"kF32Products": 1},
    "4 products (lo·lo too)": {"kF32Products": 4},
    "one block an SM": {"kF32MinBlocks": 1},
    "32-key tiles": {"kF32Keys": 32},
    "64 rows a block": {"kF32Warps": 4},
}
SHAPES = [  # (what, B, S, H, causal)
    ("eval vision", 32, 197, 12, False),
    ("eval text causal", 320, 77, 8, True),
    ("serving vision", 64, 197, 12, False),
    ("serving text causal", 64, 77, 8, True),
]


# The ceiling of mma.sync TF32 on the card: each warp issues ``iters``
# rounds of 8 independent m16n8k8 products on operands in registers.
CEILING_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32_mma.cuh"

__global__ void __launch_bounds__(256) hmma_tf32_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + i) << 13;
  b[0] = threadIdx.x << 13;
  b[1] = (threadIdx.x + 1) << 13;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) tf32::mma_tf32(c[j], a, b);
  float sum = 0.f;
  for (int j = 0; j < 8; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int cfa_hmma_tf32_rate(float* out, int blocks, int iters, void* stream) {
  hmma_tf32_rate<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def tf32_ceiling(where: Path) -> dict:
    """TFLOP/s of ``mma.sync.m16n8k8`` TF32 alone (:data:`CEILING_SOURCE`),
    8 blocks of 8 warps an SM, timed with CUDA events."""
    import chip_smoke as smoke

    src = where / "ceiling.cu"
    shutil.copytree(_build.CSRC, where / "csrc")
    src.write_text(CEILING_SOURCE)
    lib = where / "ceiling.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(where / "csrc"), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).cfa_hmma_tf32_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if fn(out.data_ptr(), blocks, iters, stream) != 0:
            raise RuntimeError("the TF32 rate kernel did not launch")

    ms = smoke.cuda_time_ms(run, reps=5)
    flops = blocks * 8 * iters * 8 * 2.0 * 16 * 8 * 8
    return {"mma_sync_tf32_tflops": flops / (ms * 1e9), "ms": ms,
            "peak_tf32_tflops": smoke.PEAK_FLOPS["tf32"] / 1e12}


def with_constants(values: Dict[str, int], name: str = NAME) -> str:
    """The source of kernel ``name`` (by default attention_fwd.cu) with
    each ``constexpr int <const> = <n>;`` of ``values`` set to its value;
    each must be on exactly one line."""
    source = (_build.CSRC / _build.SOURCES[name]).read_text()
    for const, value in values.items():
        source, n = re.subn(rf"constexpr int {const} = \d+;",
                            f"constexpr int {const} = {value};", source)
        if n != 1:
            raise ValueError(f"{const} is set on {n} lines of {name}")
    return source


def main(argv: Optional[List[str]] = None) -> List[dict]:
    import chip_smoke as smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", nargs="*", default=[],
                    help="other attention_fwd.cu files to build and time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the study runs the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load(NAME)
    tmp = Path(tempfile.mkdtemp())
    sources = {variant: with_constants(values)
               for variant, values in VARIANTS.items()}
    for path in args.baseline:
        sources[f"baseline {path}"] = Path(path).read_text()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda item: build(NAME, item[1], tmp / str(item[0])),
            enumerate(sources.values()))))
    builds = [("as built", None)] + list(libs.items())
    logs = [_build.build_logs.get(NAME, "")] + [
        _build.build_logs[str(tmp / str(i) / "variant.so")]
        for i in range(len(sources))]
    paths = [_build.library_path(NAME)] + [
        tmp / str(i) / "variant.so" for i in range(len(sources))]

    def fp32(report):
        return {k: r for k, r in report.items()
                if not k.startswith("attention_fwd_mma")}

    for (variant, _), text, path in zip(builds, logs, paths):
        print(json.dumps({"build": variant,
                          "ptxas": fp32(smoke.ptxas_report(text)),
                          "sass": fp32(sass_mix(path))}), flush=True)
    order = builds + builds[::-1]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 9)
    rows = []
    for what, B, S, H, causal in SHAPES:
        D = 64
        x = torch.randn(B, S, 3 * H * D, device="cuda", generator=gen)
        q, k, v = (x[..., i * H * D:(i + 1) * H * D].contiguous()
                   .view(B, S, H, D) for i in range(3))
        bias = (torch.full((S, S), ta.NEG, device="cuda").triu(1)[None, None]
                if causal else None)
        scale = D ** -0.5
        ref = ta.attention_reference(q, k, v, bias, scale)
        row = {"shape": what, "B": B, "S": S, "H": H, "Dh": D,
               "err_over_tol": {}, "ms": {}}
        for name, lib in builds:
            with loaded(NAME, lib):
                o, _ = ta._launch(q, k, v, bias, scale)
                torch.cuda.synchronize()
            row["err_over_tol"][name] = ((o - ref).abs().max().item()
                                         / smoke.KERNEL_TOL["float32"])
        times: Dict[str, List[float]] = {}
        for name, lib in order:
            with loaded(NAME, lib):
                times.setdefault(name, []).append(smoke.cuda_time_ms(
                    lambda: ta._launch(q, k, v, bias, scale)))
        row["ms"] = {name: sum(t) / len(t) for name, t in times.items()}
        row["ms_each"] = times
        row["library_ms"] = smoke.cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=bias, scale=scale))
        row.update(smoke.fused_attention_bound_ms(B, S, H, D, "float32",
                                                  causal))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, q, k, v, ref
    print(json.dumps({"ceiling": tf32_ceiling(tmp / "ceiling")}), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(smoke.gpu_line(), flush=True)
    return rows


if __name__ == "__main__":
    main()
