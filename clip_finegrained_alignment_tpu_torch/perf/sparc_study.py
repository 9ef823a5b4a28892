"""Design variants of the SPARC pooling kernels, timed against each other.

    python -m clip_finegrained_alignment_tpu_torch.perf.sparc_study

Run from the repository root on the card (it needs ``nvcc``). The SPARC
kernels take their shape from constants: ``NST`` (the ring's depth), ``KS``
(the D-slab of the K-major products) and ``KP`` (the rows of a slab of the
``[k][n]`` products) in ``csrc/sparc_common.cuh``, ``KT`` (the token slab)
and ``NSTC`` (the ring's depth) of the backward's columns kernel in
``csrc/sparc_bwd.cu``. For each variant in :data:`VARIANTS` this builds both
kernels once more with those constants set. At the train shapes (B=32,
T=77, P=197, D=512 fp32, ``chip_smoke.py``'s inputs) it holds each build's
forward and backward to the plain versions (``SPARC_TOL``, near-decision
rows left out as ``chip_smoke.py`` leaves them out) and times them in turns,
as built first and last: CUDA events over back-to-back calls and a CUDA
graph replay of the same calls (``chip_smoke.graph_ms``, without the host's
launch cost), with the backward's two kernels split by ``torch.profiler``.
Each build's machine code is summed up too: its instructions and the TF32
``HMMA`` among them, per kernel.
Then the as-built kernels at B = 4, 8, 16, 32 (graph ms): a time that
grows with B less than the work does is held up by latency in a block, one
that grows as the work does by a shared resource. It prints each build's
registers and spills, one JSON line a measurement, then the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..ops import _build
from ..ops import sparc_kernel as sk

NAMES = ("sparc_fwd", "sparc_bwd")
# The file of each constant a variant may set.
CONSTANT_FILES = {"NST": "sparc_common.cuh", "KS": "sparc_common.cuh",
                  "MTR": "sparc_common.cuh", "KMINR": "sparc_common.cuh",
                  "NT": "sparc_common.cuh",
                  "NPROD": "sparc_common.cuh",
                  "KP": "sparc_common.cuh", "KT": "sparc_bwd.cu",
                  "NSTC": "sparc_bwd.cu", "PCC": "sparc_bwd.cu", "MTC": "sparc_bwd.cu",
                  "KMINC": "sparc_bwd.cu"}
# variant -> the constants it sets
VARIANTS: Dict[str, Dict[str, int]] = {
    "hi·hi only (plain TF32, off tolerance)": {"NPROD": 1},
    "32 token rows a block": {"MTR": 2, "KMINR": 1},
    "16 warps a block, one a multiprocessor": {"NT": 512, "KMINR": 1,
                                               "KMINC": 1},
    "16 warps a block, two a multiprocessor": {"NT": 512, "KMINC": 1},
}
BATCHES = (4, 8, 16, 32)


def with_constants(values: Dict[str, int]) -> Dict[str, str]:
    """The sources (file name -> text) with each ``constexpr int <name> =
    <n>;`` of ``values`` set to its value; each must be on exactly one line
    of its file."""
    sources: Dict[str, str] = {}
    for const, value in values.items():
        fname = CONSTANT_FILES[const]
        text = sources.get(fname, (_build.CSRC / fname).read_text())
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            raise ValueError(f"{const} is set on {n} lines of {fname}")
        sources[fname] = text
    return sources


def build(sources: Dict[str, str], where: Path) -> Dict[str, ctypes.CDLL]:
    """Both SPARC kernels from a copy of ``csrc/`` with ``sources`` written
    over it, built as ``_build`` builds them (one ``nvcc`` each, together);
    nvcc's output goes to ``_build.build_logs`` under each library's path."""
    shutil.copytree(_build.CSRC, where)
    for fname, text in sources.items():
        (where / fname).write_text(text)
    procs = {}
    for name in NAMES:
        out = where / f"{name}.so"
        procs[name] = (out, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(where / _build.SOURCES[name])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _build.build_logs[str(out)] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n"
                               f"{_build.build_logs[str(out)]}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def sass_mix(lib) -> Dict[str, Dict[str, int]]:
    """Each kernel's machine instructions and TF32 ``HMMA`` among them, from
    ``cuobjdump --dump-sass`` (the code as compiled, not as executed)."""
    import chip_smoke as smoke

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "--dump-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = smoke.kernel_name(m.group(1))
            out[name] = {"instructions": 0, "hmma_tf32": 0}
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln):
            out[name]["instructions"] += 1
            if "HMMA" in ln and "TF32" in ln:
                out[name]["hmma_tf32"] += 1
    return out


def use(libs: Optional[Dict[str, ctypes.CDLL]], built: Dict[str, ctypes.CDLL]):
    """The SPARC wrappers launch from ``libs`` (None: as built)."""
    for name in NAMES:
        _build._libs[name] = (libs or built)[name]


def main() -> List[dict]:
    import chip_smoke as smoke

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the study runs the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    built = {name: _build.load(name) for name in NAMES}
    tmp = Path(tempfile.mkdtemp())
    builds = [("as built", None)]
    logs = [[_build.build_logs.get(name, "") for name in NAMES]]
    for i, (variant, values) in enumerate(VARIANTS.items()):
        builds.append((variant, build(with_constants(values), tmp / str(i))))
        logs.append([_build.build_logs[str(tmp / str(i) / f"{name}.so")]
                     for name in NAMES])
    for i, ((variant, _), texts) in enumerate(zip(builds, logs)):
        report, mix = {}, {}
        for name, text in zip(NAMES, texts):
            report.update(smoke.ptxas_report(text))
            lib = (_build.library_path(name) if i == 0
                   else tmp / str(i - 1) / f"{name}.so")
            mix.update(sass_mix(lib))
        print(json.dumps({"build": variant, "ptxas": report, "sass": mix}),
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 3)
    T, P, D, tau = 77, 197, 512, 0.5
    rows = []
    try:
        v, l, mask, g = smoke.sparc_inputs(gen, 32, T, P, D)
        near = smoke.sparc_near_rows(v, l, mask, tau)
        keep_row, keep_b = ~near[:, :, None], ~near.any(-1)[:, None, None]
        ref = sk.sparc_pooling_reference(v, l, mask, tau)
        rdv, rdl = sk.sparc_pooling_backward_reference(v, l, mask, tau, g)
        row = {"B": 32, "T": T, "P": P, "D": D, "err": {}, "ms": {},
               "graph_ms": {}, "profile_ms": {}}
        for variant, libs in builds:
            use(libs, built)
            out, *res = sk._launch(v, l, mask, tau)
            dv, dl = sk._launch_backward(v, l, mask, tau, g, *res)
            torch.cuda.synchronize()
            row["err"][variant] = {
                "out": ((out - ref).abs() * keep_row).max().item(),
                "dl": ((dl - rdl).abs() * keep_row).max().item(),
                "dv": ((dv - rdv).abs() * keep_b).max().item()}
            row["profile_ms"][variant] = smoke.kernel_table(
                lambda: (sk._launch(v, l, mask, tau),
                         sk._launch_backward(v, l, mask, tau, g, *res))
            )["port_kernels_ms"]
        for variant, libs in builds + builds[::-1]:
            use(libs, built)
            res = sk._launch(v, l, mask, tau)[1:]
            for kind, fn in (
                    ("fwd", lambda: sk._launch(v, l, mask, tau)),
                    ("bwd", lambda: sk._launch_backward(v, l, mask, tau, g,
                                                        *res))):
                row["ms"].setdefault(variant, {}).setdefault(kind, []).append(
                    smoke.cuda_time_ms(fn))
                row["graph_ms"].setdefault(variant, {}).setdefault(
                    kind, []).append(smoke.graph_ms(fn))
        print(json.dumps(row), flush=True)
        rows.append(row)
        use(None, built)
        for B in BATCHES:
            v, l, mask, g = smoke.sparc_inputs(gen, B, T, P, D)
            res = sk._launch(v, l, mask, tau)[1:]
            row = {"B": B, "graph_ms": {
                "fwd": smoke.graph_ms(lambda: sk._launch(v, l, mask, tau)),
                "bwd": smoke.graph_ms(
                    lambda: sk._launch_backward(v, l, mask, tau, g, *res))}}
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        use(None, built)
        shutil.rmtree(tmp, ignore_errors=True)
    print(smoke.gpu_line(), flush=True)
    return rows


if __name__ == "__main__":
    main()
