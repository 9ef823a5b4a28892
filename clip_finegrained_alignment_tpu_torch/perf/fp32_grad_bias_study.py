"""Where the float32 attention backward's gradients part from the CPU's:
the rounding of the TF32 tensor cores' fp32 sums, measured.

    python -m clip_finegrained_alignment_tpu_torch.perf.fp32_grad_bias_study \
        [--baseline FILE]

Run from the repository root on the card (it needs ``nvcc``). Three
readings, one JSON line each, then the card's name and power limit
(``--baseline``: another ``attention_bwd.cu``, say an earlier commit's
saved under the git-ignored ``_probe/``, built against this tree's
headers and read beside the kernel as built in readings 2 and 3):

1. ``mma``: how ``mma.sync.m16n8k8`` with TF32 operands rounds its fp32
   sum d = c + Σ a·b (:data:`PROBE_SOURCE`, one product a warp). The
   operands are TF32 values, so every product and the sum are exact in
   float64; each output is classed as equal to that sum rounded to
   nearest (``rn``) or toward zero (``rz``), over the outputs where the
   two differ, with the mean signed error in units of the last place
   (negative: toward zero). Sets: ``random`` (a, b, c standard normal),
   ``accumulating`` (products 2^-10 of c, as a long running sum sees
   them) and ``crafted`` (c = ±1, one product 0.75 of c's last place).
2. ``kernel``: at ViT-B/16 vision's widths (:func:`bias_inputs`, the
   same numbers on any host) the backward's dq, dk, dv as built, built
   with four TF32 products an fp32 one (``kF32Products`` 4: lo·lo too)
   and from the plain version in fp32 (TF32 off), each against a float64
   backward of the same inputs (:func:`backward64`): ``scale`` is
   Σ(x − ref)·ref / Σref² (a bias of the magnitude; negative: smaller),
   ``err_rel`` ‖x − ref‖ / ‖ref‖.
3. ``microbatch``: ``chip_smoke.py`` phase 6's fp32 check (ViT-B/16,
   ``TRAIN_CHECK_PAIRS`` pairs, SPARC) with the card's attention taken
   four ways: as built; the backward with four products; the plain
   backward on the card; the plain forward and backward on the card. Each
   against the CPU in fp32 (one run): the signed gradient-norm
   difference, and the tensors and groups (tower, layer, kind) whose
   share of the squared norm moved most.

The CPU side of reading 2 (the kernel's arithmetic emulated, with its
sums rounded to nearest or toward zero) is
``tests/test_torch_attention_tf32.py``.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..ops import _build
from ..ops import attention as ta
from ..ops.sparc_kernel import tf32_split

PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32_mma.cuh"

// d = c + a·b for one m16n8k8 tile a block (one warp): a 16 x 8
// row-major, b 8 x 8 (k, n) row-major, c and d 16 x 8 row-major.
__global__ void mma_probe(const float* a, const float* b, const float* c, float* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  a += blockIdx.x * 128;
  b += blockIdx.x * 64;
  c += blockIdx.x * 128;
  d += blockIdx.x * 128;
  const uint32_t af[4] = {__float_as_uint(a[g * 8 + t]), __float_as_uint(a[(g + 8) * 8 + t]),
                          __float_as_uint(a[g * 8 + t + 4]),
                          __float_as_uint(a[(g + 8) * 8 + t + 4])};
  const uint32_t bf[2] = {__float_as_uint(b[t * 8 + g]), __float_as_uint(b[(t + 4) * 8 + g])};
  float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                  c[(g + 8) * 8 + 2 * t + 1]};
  tf32::mma_tf32(acc, af, bf);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

extern "C" int cfa_mma_probe(const float* a, const float* b, const float* c, float* d,
                             int tiles, void* stream) {
  mma_probe<<<tiles, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, d);
  return (int)cudaGetLastError();
}
"""

TILES = 4096
BIAS_SHAPE = (2, 197, 12, 64)   # ViT-B/16 vision: B, S, H, Dh


# A float64's bits less the 29 low mantissa bits fp32 does not hold.
_FP32_BITS = ~((1 << 29) - 1)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` rounded to fp32 toward zero: the mantissa cut to
    fp32's 23 bits, which the cast to fp32 then takes exactly wherever
    ``x`` lies in fp32's normal range; the rest (subnormal, beyond fp32's
    largest) is stepped toward zero from the cast's nearest value."""
    cut = (x.contiguous().view(torch.int64) & _FP32_BITS).view(torch.float64)
    y = cut.float()
    odd = y.double() != cut
    if odd.any():
        z = x[odd].float()
        over = z.double().abs() > x[odd].abs()
        y[odd] = torch.where(over, torch.nextafter(z, torch.zeros_like(z)),
                             z)
    return y


def classify(d: torch.Tensor, exact: torch.Tensor) -> dict:
    """How fp32 ``d`` rounds float64 ``exact``: shares equal to the sum
    rounded to nearest and toward zero where the two differ, and the mean
    signed error in units of the last place (toward zero negative)."""
    rn, rz = exact.float(), round_toward_zero(exact)
    decisive = rn != rz
    ulp = (torch.nextafter(rn.abs(), torch.full_like(rn, math.inf))
           - rn.abs()).double()
    signed = (d.double() - exact) * exact.sign() / ulp
    return {"outputs": d.numel(), "decisive": int(decisive.sum()),
            "rn": float((d == rn)[decisive].float().mean()),
            "rz": float((d == rz)[decisive].float().mean()),
            "mean_signed_ulp": float(signed.mean())}


def probe_sets(gen: torch.Generator) -> Dict[str, tuple]:
    """name -> (a [T, 16, 8], b [T, 8, 8], c [T, 16, 8]) on the CPU, a and
    b TF32 values."""
    T = TILES

    def normal(*shape):
        return torch.randn(*shape, generator=gen)

    def tf32(x):
        return tf32_split(x)[0]

    sets = {"random": (tf32(normal(T, 16, 8)), tf32(normal(T, 8, 8)),
                       normal(T, 16, 8)),
            "accumulating": (tf32(normal(T, 16, 8) * 2 ** -5),
                             tf32(normal(T, 8, 8) * 2 ** -5),
                             normal(T, 16, 8))}
    a = torch.zeros(2, 16, 8)
    b = torch.zeros(2, 8, 8)
    a[:, :, 0] = 1.5 * 2 ** -24
    b[:, 0, :] = 1.0
    c = torch.ones(2, 16, 8)
    a[1], c[1] = -a[1], -c[1]
    sets["crafted"] = (a, b, c)
    return sets


def mma_reading(where: Path) -> dict:
    """Reading 1: the rounding of ``mma.sync`` TF32's fp32 sum."""
    shutil.copytree(_build.CSRC, where / "csrc")
    src = where / "probe.cu"
    src.write_text(PROBE_SOURCE)
    lib = where / "probe.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(where / "csrc"), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).cfa_mma_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    out = {}
    for name, (a, b, c) in probe_sets(
            torch.Generator().manual_seed(0)).items():
        ga, gb, gc = (x.contiguous().cuda() for x in (a, b, c))
        d = torch.empty_like(gc)
        err = fn(ga.data_ptr(), gb.data_ptr(), gc.data_ptr(), d.data_ptr(),
                 a.shape[0], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the probe did not launch: CUDA error {err}")
        exact = c.double() + a.double() @ b.double()
        out[name] = classify(d.cpu(), exact)
    return out


def bias_inputs():
    """fp32 bshd q, k, v, do of :data:`BIAS_SHAPE` from numpy's seed 0, the
    same on any host."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(BIAS_SHAPE)
                                  .astype(np.float32)) for _ in range(4))


def backward64(q, k, v, do, scale):
    """float64 (dq, dk, dv) of unmasked attention over q scaled and
    rounded to fp32 as the kernels scale it (no padded keys: they weigh
    nothing in a row with real keys)."""
    qs = ta._scaled_q(q, scale).double()
    k, v, do = k.double(), v.double(), do.double()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qs, k), -1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) \
        * ta.rounded_scale(scale, torch.float32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dq, dk, dv


def bias_stats(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``scale`` Σ(x − ref)·ref / Σref² and ``err_rel`` ‖x − ref‖ / ‖ref‖,
    in float64."""
    got, ref = got.double().cpu(), ref.double().cpu()
    diff = got - ref
    return {"scale": float((diff * ref).sum() / (ref * ref).sum()),
            "err_rel": float(diff.norm() / ref.norm())}


def kernel_reading(lib4, baseline=None) -> dict:
    """Reading 2: the backward's magnitude bias against float64."""
    from .attention_bwd_fp32_study import run

    q, k, v, do = bias_inputs()
    scale = q.shape[-1] ** -0.5
    ref = backward64(q, k, v, do, scale)
    q, k, v, do = (x.cuda() for x in (q, k, v, do))
    lse = ta._launch(q, k, v, None, scale, True)[1]
    ways = {"kernel, 3 products": run(_build.load("attention_bwd"), q, k, v,
                                      None, scale, do, lse),
            "kernel, 4 products": run(lib4, q, k, v, None, scale, do, lse),
            "plain fp32": ta.attention_backward_reference(q, k, v, None,
                                                          scale, do)}
    if baseline is not None:
        ways["baseline, 3 products"] = run(baseline, q, k, v, None, scale,
                                           do, lse)
    return {way: {n: bias_stats(g, r)
                  for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
            for way, got in ways.items()}


def group_of(name: str) -> str:
    """A parameter's tower, layer and kind, e.g. ``vision 3 attn``."""
    tower = name.split("_model")[0] if "_model." in name else "head"
    m = re.search(r"layers\.(\d+)\.", name)
    kind = ("attn" if "self_attn" in name else "mlp" if "mlp" in name
            else "norm" if "norm" in name else "other")
    return f"{tower} {m.group(1) if m else '-'} {kind}"


def breakdown(card, cpu) -> dict:
    """The signed gradient-norm difference of card against CPU and the
    8 tensors and groups whose squared norm moved most, as shares of the
    CPU's squared norm (they sum to about twice the norm difference)."""
    (_, n_card, g_card), (_, n_cpu, g_cpu) = card, cpu
    moved = {n: (g_card[n].double().square().sum()
                 - g.double().square().sum()).item() / n_cpu ** 2
             for n, g in g_cpu.items()}
    groups: Dict[str, float] = {}
    for n, m in moved.items():
        groups[group_of(n)] = groups.get(group_of(n), 0.0) + m
    worst = sorted(moved, key=lambda n: -abs(moved[n]))[:8]
    worst_groups = sorted(groups, key=lambda n: -abs(groups[n]))[:8]
    return {"grad_norm_rel_signed": (n_card - n_cpu) / n_cpu,
            "tensors": {n: moved[n] for n in worst},
            "groups": {n: groups[n] for n in worst_groups}}


def microbatch_reading(lib4, baseline=None) -> dict:
    """Reading 3: phase 6's fp32 check, the card's attention four ways."""
    from contextlib import ExitStack
    from unittest import mock

    import chip_smoke as smoke

    from ..config import CLIPConfig, TrainConfig
    from ..models import clip as tm
    from ..models import convert
    from .lo_half_study import loaded

    cfg = CLIPConfig.vit_b16()
    tcfg = TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                       inverse_temperature=0.07, use_amp=False)
    sd = convert.state_dict_from_jax(convert.random_params(cfg, smoke.SEED),
                                     cfg)
    batch = smoke.bench_batch(cfg, smoke.TRAIN_ACCUM, smoke.TRAIN_B, "sparc",
                              smoke.SEED)

    def grads(device, *patches):
        with ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            model = tm.build_train_model(cfg, sd, device=device)
            return smoke.microbatch_grads(model, batch, tcfg, cfg,
                                          torch.float32)

    def plain_backward(q, k, v, bias, scale, do, lse):
        return ta.attention_backward_reference(q, k, v, bias, scale, do)

    def plain_forward(q, k, v, bias, scale, want_lse=False):
        return ta.attention_reference(q, k, v, bias, scale), None

    cpu = grads("cpu")
    ways = {"as built": (),
            "backward, 4 products": (loaded("attention_bwd", lib4),),
            "backward plain": (mock.patch.object(ta, "_launch_backward",
                                                 plain_backward),),
            "forward and backward plain": (
                mock.patch.object(ta, "_launch_backward", plain_backward),
                mock.patch.object(ta, "_launch", plain_forward))}
    if baseline is not None:
        ways["backward baseline"] = (loaded("attention_bwd", baseline),)
    out = {}
    for way, patches in ways.items():
        card = grads("cuda", *patches)
        out[way] = {**breakdown(card, cpu),
                    "min_grad_cosine": smoke.compare_grads(
                        card, cpu)["min_grad_cosine"]}
    return out


def main(argv=None) -> dict:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="another attention_bwd.cu to read beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the study runs the kernels")
    import chip_smoke as smoke
    from .attention_fp32_study import with_constants
    from .lo_half_study import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load("attention_bwd")
    tmp = Path(tempfile.mkdtemp())
    try:
        lib4 = build("attention_bwd",
                     with_constants({"kF32Products": 4}, "attention_bwd"),
                     tmp / "four")
        base = None if args.baseline is None else build(
            "attention_bwd", Path(args.baseline).read_text(), tmp / "base")
        out = {"mma": mma_reading(tmp / "probe")}
        print(json.dumps({"mma": out["mma"]}), flush=True)
        out["kernel"] = kernel_reading(lib4, base)
        print(json.dumps({"kernel": out["kernel"]}), flush=True)
        out["microbatch"] = microbatch_reading(lib4, base)
        print(json.dumps({"microbatch": out["microbatch"]}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smoke.gpu_line(), flush=True)
    return out


if __name__ == "__main__":
    main()
