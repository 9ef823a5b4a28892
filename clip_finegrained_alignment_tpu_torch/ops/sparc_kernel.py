"""Fused SPARC language-grouped patch pooling: the CUDA kernels and their
plain twins, joined by an ``autograd.Function``.

The SPARC local term chains, per batch element (``objectives/losses.py``):

    l_norm = l2_normalize(l_token)               [T, D]
    v_norm = l2_normalize(v_patch)               [P, D]
    sim    = l_norm v_normᵀ                       [T, P]
    w      = renorm(threshold(minmax(sim, mask)))  [T, P]
    out    = w v_patch                           [T, D]  (unnormalized
                                                          patches)

``fused_sparc_pooling`` replaces the Pallas TPU kernels of
``clip_finegrained_alignment_tpu/ops/sparc_kernel.py``: the forward
``_sparc_kernel`` with ``csrc/sparc_fwd.cu`` and the backward
``_sparc_bwd_kernel`` with ``csrc/sparc_bwd.cu``, written by hand for
Hopper and loaded through ``ops/_build.py``. Everything is fp32. The
kernels run their products on the tensor cores as three TF32 products
(each operand split into hi = tf32(x) and lo = tf32(x − hi), summing
lo·hi + hi·lo + hi·hi), which lands within ~1e-7 of fp32 products and
holds the 1e-4 tolerance that plain TF32 would miss; :func:`tf32_split`
emulates the split for the tests. On a CUDA tensor each direction launches
its kernel or raises; on a CPU tensor it runs
:func:`sparc_pooling_reference` or :func:`sparc_pooling_backward_reference`.

On the card the forward also saves sim [B, T, P] and the inverse norms
rl [B, T], rv [B, P], and the backward reads them: its threshold and tie
decisions are the forward's own numbers (the TPU kernel recomputes them).
On the CPU the inputs alone are saved, as in JAX.

The backward is the TPU kernel's hand-derived VJP, not autodiff of the
chain: min/max cotangents split evenly among ties, ``z < τ`` passes no
gradient, and the ``clip(Σt, 1e-8)`` and ``max(Σx², eps²)`` guards gate
their terms with strict inequalities (``denom_raw > 1e-8``,
``Σx² > eps²``), where autodiff splits 50/50 at an exact tie.

Bound at B=32, T=77, P=197, D=512 on an H100 (3.35 TB/s, 495 TFLOP/s
TF32 dense, three TF32 products for each fp32 one): the forward moves
~25.0 MB with the saved sim (7.5 us, bytes; its 1.0 GFLOP take 6.0 us);
the backward ~42.9 MB (12.8 us, bytes; its 2.0 GFLOP 12.1 us).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "sparc_fwd"
BACKWARD_KERNEL = "sparc_bwd"

EPS = 1e-8          # objectives/losses.py _EPS
NORM_EPS = 1e-12    # l2_normalize's eps (torch F.normalize's)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = NORM_EPS) -> torch.Tensor:
    """``x · rsqrt(max(Σx², eps²))``: torch ``F.normalize`` values (a zero
    row normalizes to zeros) with gradients that are finite everywhere, as
    the JAX package's ``l2_normalize``."""
    sumsq = (x * x).sum(dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sumsq, eps * eps))


def sparc_alignment_weights(similarity: torch.Tensor,
                            language_mask: torch.Tensor,
                            similarity_threshold: float) -> torch.Tensor:
    """Masked min–max normalization, thresholding and renormalization of
    ``similarity`` [B, T, P] under ``language_mask`` [B, T]. Masked rows
    take the ±2 sentinel (cosines lie in [-1, 1]) and come out zero."""
    mask = language_mask.to(similarity.dtype)[:, :, None]
    sim_masked = similarity * mask
    sim_min = torch.where(mask > 0, sim_masked, 2.0).amin(-1, keepdim=True)
    sim_max = torch.where(mask > 0, sim_masked, -2.0).amax(-1, keepdim=True)
    normalized = (sim_masked - sim_min) / (sim_max - sim_min + EPS)
    thresholded = torch.where(normalized < similarity_threshold,
                              torch.zeros_like(normalized), normalized)
    thresholded = thresholded * mask
    return thresholded / torch.clamp_min(
        thresholded.sum(-1, keepdim=True), EPS)


def tf32_split(x: torch.Tensor):
    """(hi, lo) fp32 tensors: hi = x rounded to TF32 (10 mantissa bits) to
    nearest, ties away from zero, and lo = (x − hi) rounded the same way,
    as ``cvt.rna.tf32.f32`` rounds a finite x and as the kernels split
    their operands (``csrc/sparc_common.cuh::split``), by integer
    arithmetic on the fp32 bits. Used by the tests to emulate the kernels'
    products."""
    def rna(y):
        bits = y.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _inverse_norm(x: torch.Tensor) -> torch.Tensor:
    """rsqrt(max(Σx², eps²)) over the last dim, keepdim: l2_normalize's
    factor."""
    return torch.rsqrt(torch.clamp_min((x * x).sum(-1, keepdim=True),
                                       NORM_EPS * NORM_EPS))


def sparc_pooling_reference(v_patch: torch.Tensor, l_token: torch.Tensor,
                            mask: torch.Tensor, threshold: float,
                            return_residuals: bool = False):
    """The plain chain (the port of ``_reference_chain``): [B, T, D] fp32.
    With ``return_residuals``, (out, sim [B, T, P], rl [B, T], rv [B, P]):
    what the CUDA forward saves for the backward."""
    v32, l32 = v_patch.float(), l_token.float()
    rl, rv = _inverse_norm(l32), _inverse_norm(v32)
    sim = torch.einsum("btd,bpd->btp", l32 * rl, v32 * rv)
    w = sparc_alignment_weights(sim, mask, threshold)
    out = torch.einsum("btp,bpd->btd", w, v32)
    if return_residuals:
        return out, sim, rl[..., 0], rv[..., 0]
    return out


def sparc_pooling_backward_reference(v_patch, l_token, mask, threshold, g,
                                     residuals=None, einsum=torch.einsum):
    """The TPU kernel's hand-derived VJP (``_sparc_bwd_kernel``) in plain
    PyTorch: (dv, dl) in the inputs' types. It recomputes the chain, or,
    given ``residuals`` = (sim, rl, rv) of the forward, takes sim and the
    inverse norms from them, as the CUDA backward does. ``einsum`` computes
    its products (the tests pass an emulation of the kernels')."""
    v, l, g = v_patch.float(), l_token.float(), g.float()
    m = mask.float()[:, :, None]
    nege = NORM_EPS * NORM_EPS
    v_sq = (v * v).sum(-1, keepdim=True)
    l_sq = (l * l).sum(-1, keepdim=True)
    if residuals is None:
        rv = torch.rsqrt(torch.clamp_min(v_sq, nege))
        rl = torch.rsqrt(torch.clamp_min(l_sq, nege))
        sim = einsum("btd,bpd->btp", l * rl, v * rv)
    else:
        sim, rl, rv = (r.float() for r in residuals)
        rl, rv = rl[..., None], rv[..., None]
    v_norm, l_norm = v * rv, l * rl
    sm = sim * m
    consider = (m > 0).expand_as(sim)
    mn = torch.where(consider, sm, 2.0).amin(-1, keepdim=True)
    mx = torch.where(consider, sm, -2.0).amax(-1, keepdim=True)
    s = mx - mn + EPS
    z = (sm - mn) / s
    thr = torch.where(z < threshold, torch.zeros_like(z), z)
    t = torch.where(consider, thr * m, torch.zeros_like(z))
    denom_raw = t.sum(-1, keepdim=True)
    denom = torch.clamp_min(denom_raw, EPS)
    w = t / denom

    dw = einsum("btd,bpd->btp", g, v)
    dv = einsum("btp,btd->bpd", w, g)
    active = (denom_raw > EPS).float()
    dt = dw / denom - active * (dw * t).sum(-1, keepdim=True) / (denom * denom)
    dz = torch.where((z < threshold) | ~consider, torch.zeros_like(z), dt * m)
    dsm = dz / s
    a = (dz * (z - 1.0)).sum(-1, keepdim=True) / s
    b = (dz * (-z)).sum(-1, keepdim=True) / s
    eq_mn = consider & (sm == mn)
    eq_mx = consider & (sm == mx)
    n_mn = torch.clamp_min(eq_mn.float().sum(-1, keepdim=True), 1.0)
    n_mx = torch.clamp_min(eq_mx.float().sum(-1, keepdim=True), 1.0)
    zero = torch.zeros_like(dsm)
    dsm = dsm + torch.where(eq_mn, a / n_mn, zero) \
        + torch.where(eq_mx, b / n_mx, zero)
    dsim = dsm * m

    dl_norm = einsum("btp,bpd->btd", dsim, v_norm)
    dv_norm = einsum("btp,btd->bpd", dsim, l_norm)
    act_v = (v_sq > nege).float()
    act_l = (l_sq > nege).float()
    dv = dv + dv_norm * rv \
        - v * (dv_norm * v).sum(-1, keepdim=True) * (rv * rv * rv) * act_v
    dl = dl_norm * rl \
        - l * (dl_norm * l).sum(-1, keepdim=True) * (rl * rl * rl) * act_l
    return dv.to(v_patch.dtype), dl.to(l_token.dtype)


def _check(v, l, mask) -> None:
    if v.dim() != 3 or l.dim() != 3 or v.shape[0] != l.shape[0] \
            or v.shape[2] != l.shape[2]:
        raise ValueError(f"v_patch must be [B, P, D] and l_token [B, T, D], "
                         f"got {tuple(v.shape)} and {tuple(l.shape)}")
    if mask.shape != l.shape[:2]:
        raise ValueError(f"mask must be [B, T] = {tuple(l.shape[:2])}, "
                         f"got {tuple(mask.shape)}")
    if min(v.shape) < 1 or min(l.shape) < 1:
        raise ValueError("empty SPARC pooling input")
    if not (v.is_floating_point() and l.is_floating_point()):
        raise ValueError(f"v_patch and l_token must be floating point, got "
                         f"{v.dtype} and {l.dtype}")
    if l.device != v.device or mask.device != v.device:
        raise ValueError("v_patch, l_token and mask lie on different devices")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _launch(v, l, mask, threshold):
    """The forward kernel: (out [B, T, D], sim [B, T, P], rl [B, T],
    rv [B, P]), fp32."""
    B, P, D = v.shape
    T = l.shape[1]
    fn = _build.load(KERNEL).cfa_sparc_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    v, l, mask = _f32(v), _f32(l), _f32(mask)
    out = torch.empty((B, T, D), dtype=torch.float32, device=v.device)
    sim = torch.empty((B, T, P), dtype=torch.float32, device=v.device)
    rl = torch.empty((B, T), dtype=torch.float32, device=v.device)
    rv = torch.empty((B, P), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), l.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 sim.data_ptr(), rl.data_ptr(), rv.data_ptr(),
                 B, T, P, D, float(threshold),
                 torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: error {err} "
                           f"(-1: shapes beyond a block's shared memory)")
    _build.LAUNCHES[KERNEL].add()
    return out, sim, rl, rv


def _launch_backward(v_in, l_in, mask, threshold, g, sim, rl, rv):
    """The backward kernels, fed the forward kernel's sim, rl and rv:
    (dv, dl) in the inputs' types."""
    B, P, D = v_in.shape
    T = l_in.shape[1]
    fn = _build.load(BACKWARD_KERNEL).cfa_sparc_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
    v, l, mask, g = _f32(v_in), _f32(l_in), _f32(mask), _f32(g)
    sim, rl, rv = _f32(sim), _f32(rl), _f32(rv)
    dv = torch.empty((B, P, D), dtype=torch.float32, device=v.device)
    dl = torch.empty((B, T, D), dtype=torch.float32, device=v.device)
    # w, dsim * rl * rv and dsim * sim, written by the rows kernel, read by
    # the columns kernel.
    scratch = torch.empty((3, B, T, P), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), l.data_ptr(), mask.data_ptr(), g.data_ptr(),
                 sim.data_ptr(), rl.data_ptr(), rv.data_ptr(),
                 dv.data_ptr(), dl.data_ptr(), scratch.data_ptr(),
                 B, T, P, D, float(threshold),
                 torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BACKWARD_KERNEL} kernel launch failed: error "
                           f"{err} (-1: shapes beyond a block's shared memory)")
    _build.LAUNCHES[BACKWARD_KERNEL].add()
    return dv.to(v_in.dtype), dl.to(l_in.dtype)


def _device_kind(t: torch.Tensor) -> str:
    return t.device.type


class FusedSparcPooling(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    port of ``_fused_sparc_pooling_vjp``); saves the inputs and, on the
    card, the forward's sim, rl and rv. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, v_patch, l_token, mask, threshold):
        ctx.threshold = threshold
        kind = _device_kind(v_patch)
        if kind == "cuda":
            out, sim, rl, rv = _launch(v_patch, l_token, mask, threshold)
            ctx.save_for_backward(v_patch, l_token, mask, sim, rl, rv)
            return out
        if kind == "cpu":
            ctx.save_for_backward(v_patch, l_token, mask)
            return sparc_pooling_reference(v_patch, l_token, mask, threshold)
        raise ValueError(f"no SPARC pooling for device {v_patch.device}")

    @staticmethod
    def backward(ctx, g):
        v_patch, l_token, mask, *residuals = ctx.saved_tensors
        kind = _device_kind(v_patch)
        if kind == "cuda":
            dv, dl = _launch_backward(v_patch, l_token, mask, ctx.threshold, g,
                                      *residuals)
        elif kind == "cpu":
            dv, dl = sparc_pooling_backward_reference(
                v_patch, l_token, mask, ctx.threshold, g)
        else:
            raise ValueError(f"no SPARC backward for device {v_patch.device}")
        return dv, dl, None, None


def fused_sparc_pooling(v_patch: torch.Tensor, l_token: torch.Tensor,
                        mask: torch.Tensor, threshold: float) -> torch.Tensor:
    """Language-grouped patch pooling: v_patch [B, P, D] projected patch
    embeddings (unnormalized), l_token [B, T, D], mask [B, T] → [B, T, D]
    fp32, differentiable in v_patch and l_token.

    CUDA tensors launch ``csrc/sparc_fwd.cu`` (and, in the backward,
    ``csrc/sparc_bwd.cu``); CPU tensors run the plain versions."""
    _check(v_patch, l_token, mask)
    return FusedSparcPooling.apply(v_patch, l_token, mask.detach(), threshold)
