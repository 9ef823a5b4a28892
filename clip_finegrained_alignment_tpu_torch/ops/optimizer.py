"""Multi-tensor clip by global norm and AdamSPD: the optimizer phase of a
train step over every parameter tensor in a handful of launches.

The functions, each over a list of tensors:

* :func:`global_norm`: sqrt(Σ‖t‖²) in fp32 (optax's ``global_norm``), as
  :func:`norm_of_rows` of :func:`sumsq_rows` (each tensor's Σt²): under
  ZeRO-1, FSDP, TP and PP the rows are added over the ranks in between
  (``parallel/zero.py::ShardLayout.grad_norm``), so one rank's norm is
  the norm without a mesh, bit for bit;
* :func:`clip_`: ``g ← where(norm < max, g, g / norm · max)`` in place,
  the norm a device scalar (no host sync);
* :func:`adamspd_update`: AdamSPD's first pass (``optim/adamspd.py``): the
  moments and the Adam step in place, and each tensor's sums
  ``[−Σ g·(p − pre), Σ(new − pre)², Σ(p − pre)²]`` as ``[n, 3]`` fp32;
* :func:`adamspd_project`: the second pass, ``p − (wd·ratio)·(p − pre)``
  for each tensor whose condition (its first sum) is below 0.

On CUDA tensors each is one or two hand-written kernels
(``csrc/optimizer.cu``: ``clip_sumsq`` + ``clip_rows``, ``clip_norm``,
``clip_scale``, ``adamspd_update`` + ``adamspd_sums``,
``adamspd_project``), each launch
walking a table of (tensor, chunk) pairs over all the tensors; on CPU
tensors the plain versions here, the per-tensor loops the optimizer ran
before, kept as the reference the card's kernels are held to
(``chip_smoke.py`` phase 3). No other device is taken, and the kernels
take fp32 tensors only (the configuration's masters).

The table: one record a tensor, built on the host each step (gradients
are new tensors every step) and copied to the card from pinned memory.
A tensor's elements are ``runs`` runs of ``inner`` contiguous elements
(:func:`runs_of`): a contiguous tensor is one run, a ZeRO-1 shard split
along a later dimension (a view) many. Each run is cut into chunks of
:data:`CHUNK` elements, one block a chunk.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

SUMSQ_KERNEL = "clip_sumsq"
ROWS_KERNEL = "clip_rows"
NORM_KERNEL = "clip_norm"
SCALE_KERNEL = "clip_scale"
UPDATE_KERNEL = "adamspd_update"
SUMS_KERNEL = "adamspd_sums"
PROJECT_KERNEL = "adamspd_project"
KERNELS = (SUMSQ_KERNEL, ROWS_KERNEL, NORM_KERNEL, SCALE_KERNEL,
           UPDATE_KERNEL, SUMS_KERNEL, PROJECT_KERNEL)

CHUNK = 16384           # elements a block takes (csrc/optimizer.cu kChunk)

# The records of csrc/optimizer.cu, field for field.
GRAD_RECORD = np.dtype([
    ("g", "<u8"), ("inner", "<i8"), ("g_stride", "<i8"),
    ("first_chunk", "<i4"), ("run_chunks", "<i4")])
ADAM_RECORD = np.dtype([
    ("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"), ("pre", "<u8"),
    ("vmax", "<u8"), ("inner", "<i8"), ("p_stride", "<i8"),
    ("g_stride", "<i8"), ("first_chunk", "<i4"), ("run_chunks", "<i4"),
    ("step_size", "<f4"), ("sqrt_bc2", "<f4"), ("b1", "<f4"),
    ("omb1", "<f4"), ("b2", "<f4"), ("omb2", "<f4"), ("eps", "<f4"),
    ("unused", "<f4")])
PROJECT_RECORD = np.dtype([
    ("p", "<u8"), ("pre", "<u8"), ("inner", "<i8"), ("p_stride", "<i8"),
    ("first_chunk", "<i4"), ("run_chunks", "<i4"), ("wd", "<f4"),
    ("unused", "<f4")])


class AdamHyper(NamedTuple):
    """One tensor's constants for a step: the learning rate over the first
    bias correction, the square root of the second (both fp32, as the JAX
    package takes them), the betas and eps."""
    step_size: float
    sqrt_bc2: float
    b1: float
    b2: float
    eps: float


@functools.lru_cache(maxsize=256)
def adam_hyper(lr: float, b1: float, b2: float, eps: float,
               step: int) -> AdamHyper:
    """The constants of update number ``step`` (1 for the first)."""
    count = np.float32(step)
    bc1 = np.float32(1.0) - np.float32(b1) ** count
    bc2 = np.float32(1.0) - np.float32(b2) ** count
    return AdamHyper(float(np.float32(lr) / bc1), float(np.sqrt(bc2)), b1,
                     b2, eps)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path; chip_smoke.py holds the kernels to them)
# ---------------------------------------------------------------------------

def sumsq_rows_reference(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().pow(2).sum() for t in tensors])


def norm_of_rows_reference(rows: torch.Tensor) -> torch.Tensor:
    return rows.sum().sqrt()


def global_norm_reference(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return norm_of_rows_reference(sumsq_rows_reference(tensors))


def clip_reference(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                   max_norm: float) -> None:
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def adamspd_update_reference(params, grads, exp_avgs, exp_avg_sqs,
                             max_exp_avg_sqs, anchors,
                             hypers: Sequence[AdamHyper]) -> torch.Tensor:
    rows = []
    for p, g, m, v, vmax, pre, h in zip(params, grads, exp_avgs,
                                        exp_avg_sqs, max_exp_avg_sqs,
                                        anchors, hypers):
        if g is None:
            g = torch.zeros_like(p)
        m.mul_(h.b1).add_(g, alpha=1 - h.b1)
        v.mul_(h.b2).add_(g * g, alpha=1 - h.b2)
        if vmax is not None:
            torch.maximum(vmax, v, out=vmax)
            v = vmax
        denom = v.sqrt() / h.sqrt_bc2 + h.eps
        condition = -(g * (p - pre)).sum()
        prev_sq = (p - pre).pow(2).sum()
        p.copy_(p - h.step_size * m / denom)
        rows.append(torch.stack([condition, (p - pre).pow(2).sum(),
                                 prev_sq]))
    return torch.stack(rows)


def adamspd_project_reference(params, anchors, sums: torch.Tensor,
                              weight_decays: Sequence[float]) -> None:
    for p, pre, wd, (condition, curr_sq, prev_sq) in zip(
            params, anchors, weight_decays, sums.unbind(0)):
        curr, prev = curr_sq.sqrt(), prev_sq.sqrt()
        safe = torch.where(curr == 0, torch.ones_like(curr), curr)
        ratio = torch.where(curr == 0, torch.zeros_like(curr),
                            (curr - prev) / safe).clamp(0.0, 1.0)
        projected = p - wd * ratio * (p - pre)
        p.copy_(torch.where(condition < 0, projected, p))


# ---------------------------------------------------------------------------
# The tables and the kernels (csrc/optimizer.cu)
# ---------------------------------------------------------------------------

def runs_of(t: torch.Tensor) -> Tuple[int, int, int]:
    """(runs, inner, stride): ``t``'s elements in row-major order as
    ``runs`` runs of ``inner`` contiguous elements, run r starting
    ``r · stride`` elements past the first; raises ValueError for a
    layout of no such form."""
    if t.is_contiguous():
        return 1, t.numel(), t.numel()
    dims = [(s, st) for s, st in zip(t.shape, t.stride()) if s != 1]
    inner, k = 1, len(dims)
    while k and dims[k - 1][1] == inner:
        inner *= dims[k - 1][0]
        k -= 1
    if k == 0:
        return 1, inner, inner
    runs, stride = dims[k - 1]
    for s, st in reversed(dims[:k - 1]):
        if st != stride * runs:
            raise ValueError(f"a tensor of shape {tuple(t.shape)} and "
                             f"strides {t.stride()} is not runs of equal "
                             "stride")
        runs *= s
    if stride < inner:
        raise ValueError(f"overlapping runs: shape {tuple(t.shape)}, "
                         f"strides {t.stride()}")
    return runs, inner, stride


def _layout(tensors: Sequence[torch.Tensor], strided, contiguous, what: str,
            device) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             List[np.ndarray], int]:
    """Each tensor's (inner, first chunk, chunks a run), its ``strided``
    operands' run strides (one array each) and the total chunk count. Each
    tensor ``i``: the operands ``strided[j][i]`` (None skipped) may be
    views of runs, ``contiguous[j][i]`` (None skipped) must be
    contiguous; all of ``tensors[i]``'s shape, fp32 and on ``device``."""
    shapes = [t.shape for t in tensors]
    f32 = torch.float32
    for xs in (*strided, *contiguous):
        bad = [x for x, s in zip(xs, shapes) if x is not None and (
            x.dtype is not f32 or x.shape != s or x.device != device)]
        if bad:
            x = bad[0]
            raise ValueError(
                f"{what} on the card takes fp32 tensors of their "
                f"parameter's shape on {device}; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    for xs in contiguous:
        if not all(x is None or x.is_contiguous() for x in xs):
            raise ValueError(f"{what}: the optimizer's state must be "
                             "contiguous")
    numel = [t.numel() for t in tensors]
    inner = list(numel)
    strides = [list(numel) for _ in strided]
    views = [{i for i, x in enumerate(xs)
              if x is not None and not x.is_contiguous()} for xs in strided]
    # The views' runs; a contiguous operand of the same tensor takes them
    # with a stride of one run.
    for j, i in sorted((j, i) for j, vs in enumerate(views) for i in vs):
        runs, inn, stride = runs_of(strided[j][i])
        if inner[i] not in (numel[i], inn):
            raise ValueError(f"{what}: operands of shape "
                             f"{tuple(shapes[i])} are views of different "
                             "layouts")
        inner[i] = inn
        strides[j][i] = stride
    for j, vs in enumerate(views):
        for i in range(len(tensors)):
            if i not in vs and inner[i] != numel[i]:
                strides[j][i] = inner[i]
    inner = np.array(inner, dtype=np.int64)
    run_chunks = -(-inner // CHUNK)
    chunks = run_chunks * (np.array(numel, dtype=np.int64)
                           // np.maximum(inner, 1))
    first = np.cumsum(chunks) - chunks
    total = int(chunks.sum())
    if total >= 2 ** 31:
        raise ValueError(f"{what}: {total} chunks, more than a grid takes")
    return inner, first, run_chunks, [np.array(x, dtype=np.int64)
                                      for x in strides], total


def _ptrs(tensors) -> List[int]:
    return [0 if t is None else t.data_ptr() for t in tensors]


def _upload(records: np.ndarray, device) -> torch.Tensor:
    """The records on ``device``: copied from pinned memory on the current
    stream (the caching host allocator keeps the buffer until the copy has
    run)."""
    host = torch.from_numpy(records.view(np.uint8)).pin_memory()
    return host.to(device, non_blocking=True)


def _entry(name: str, argtypes):
    fn = getattr(_build.load(name), f"cfa_{name}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err} "
                           "(-1: arguments it does not take)")


def _launch(name: str, argtypes, device, *args) -> None:
    fn = _entry(name, argtypes + [ctypes.c_void_p])
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, name)
    _build.LAUNCHES[name].add()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _grad_table(grads: Sequence[torch.Tensor], device, what: str):
    if any(g is None for g in grads):
        raise ValueError(f"{what} takes no None gradient")
    inner, first, run_chunks, (strides,), total = _layout(
        grads, [grads], [], what, device)
    rec = np.zeros(len(grads), dtype=GRAD_RECORD)
    rec["g"] = _ptrs(grads)
    rec["inner"], rec["g_stride"] = inner, strides
    rec["first_chunk"], rec["run_chunks"] = first, run_chunks
    return _upload(rec, device), total


def _launch_sumsq_rows(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    device = tensors[0].device
    table, total = _grad_table(tensors, device, "sumsq_rows")
    partial = torch.empty(max(total, 1), dtype=torch.float32, device=device)
    rows = torch.empty(len(tensors), dtype=torch.float32, device=device)
    if total:
        _launch(SUMSQ_KERNEL, [_P, _I, _I, _P], device, table.data_ptr(),
                len(tensors), total, partial.data_ptr())
    _launch(ROWS_KERNEL, [_P, _I, _I, _P, _P], device, table.data_ptr(),
            len(tensors), total, partial.data_ptr(), rows.data_ptr())
    return rows


def _launch_norm_of_rows(rows: torch.Tensor) -> torch.Tensor:
    if rows.dim() != 1 or rows.dtype != torch.float32:
        raise ValueError(f"norm_of_rows on the card takes an fp32 vector, "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    rows = rows.contiguous()
    norm = torch.empty((), dtype=torch.float32, device=rows.device)
    _launch(NORM_KERNEL, [_P, _I, _P], rows.device, rows.data_ptr(),
            rows.numel(), norm.data_ptr())
    return norm


def _launch_clip(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                 max_norm: float) -> None:
    device = grads[0].device
    if norm.shape != () or norm.dtype != torch.float32 \
            or norm.device != device:
        raise ValueError(f"clip_ on the card takes an fp32 scalar norm on "
                         f"{device}, got {norm.dtype} {tuple(norm.shape)} on "
                         f"{norm.device}")
    table, total = _grad_table(grads, device, "clip_")
    if total:
        _launch(SCALE_KERNEL, [_P, _I, _I, _P, _F], device, table.data_ptr(),
                len(grads), total, norm.data_ptr(), max_norm)


def _adam_table(params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs,
                anchors, hypers):
    device = params[0].device
    n = len(params)
    inner, first, run_chunks, (p_strides, g_strides), total = _layout(
        params, [params, grads],
        [exp_avgs, exp_avg_sqs, anchors, max_exp_avg_sqs],
        "adamspd_update", device)
    rec = np.zeros(n, dtype=ADAM_RECORD)
    for field, ts in (("p", params), ("g", grads), ("m", exp_avgs),
                      ("v", exp_avg_sqs), ("pre", anchors),
                      ("vmax", max_exp_avg_sqs)):
        rec[field] = _ptrs(ts)
    rec["inner"], rec["p_stride"], rec["g_stride"] = inner, p_strides, \
        g_strides
    rec["first_chunk"], rec["run_chunks"] = first, run_chunks
    h = np.array(hypers, dtype=np.float64).reshape(n, 5)
    for j, field in enumerate(("step_size", "sqrt_bc2", "b1")):
        rec[field] = h[:, j]
    rec["omb1"] = 1 - h[:, 2]       # in float64, as torch's alpha=1 - b1
    rec["b2"], rec["omb2"], rec["eps"] = h[:, 3], 1 - h[:, 3], h[:, 4]
    return _upload(rec, device), total


def _launch_adamspd_update(params, grads, exp_avgs, exp_avg_sqs,
                           max_exp_avg_sqs, anchors, hypers) -> torch.Tensor:
    device = params[0].device
    n = len(params)
    table, total = _adam_table(params, grads, exp_avgs, exp_avg_sqs,
                               max_exp_avg_sqs, anchors, hypers)
    sums = torch.empty((n, 3), dtype=torch.float32, device=device)
    partial = torch.empty((max(total, 1), 3), dtype=torch.float32,
                          device=device)
    if total:
        _launch(UPDATE_KERNEL, [_P, _I, _I, _P], device, table.data_ptr(), n,
                total, partial.data_ptr())
    _launch(SUMS_KERNEL, [_P, _I, _I, _P, _P], device, table.data_ptr(), n,
            total, partial.data_ptr(), sums.data_ptr())
    return sums


def _project_table(params, anchors, weight_decays):
    device = params[0].device
    inner, first, run_chunks, (p_strides,), total = _layout(
        params, [params], [anchors], "adamspd_project", device)
    rec = np.zeros(len(params), dtype=PROJECT_RECORD)
    rec["p"], rec["pre"] = _ptrs(params), _ptrs(anchors)
    rec["inner"], rec["p_stride"] = inner, p_strides
    rec["first_chunk"], rec["run_chunks"] = first, run_chunks
    rec["wd"] = weight_decays
    return _upload(rec, device), total


def _launch_adamspd_project(params, anchors, sums: torch.Tensor,
                            weight_decays) -> None:
    device = params[0].device
    n = len(params)
    if sums.shape != (n, 3) or sums.dtype != torch.float32 \
            or sums.device != device:
        raise ValueError(f"adamspd_project takes fp32 sums [{n}, 3] on "
                         f"{device}, got {sums.dtype} {tuple(sums.shape)}")
    sums = sums.contiguous()
    table, total = _project_table(params, anchors, weight_decays)
    if total:
        _launch(PROJECT_KERNEL, [_P, _I, _I, _P], device, table.data_ptr(), n,
                total, sums.data_ptr())


def _device_kind(t: torch.Tensor) -> str:
    return t.device.type


def _route(t: torch.Tensor, kernel, plain, *args):
    """``kernel(*args)`` on a CUDA tensor, ``plain(*args)`` on a CPU one;
    any other device raises."""
    kind = _device_kind(t)
    if kind == "cuda":
        return kernel(*args)
    if kind == "cpu":
        return plain(*args)
    raise ValueError(f"no optimizer kernels for device {t.device}")


def sumsq_rows(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each tensor's Σt² in fp32, ``[n]`` on their device. CUDA:
    ``cfa_clip_sumsq`` then ``cfa_clip_rows``; CPU:
    :func:`sumsq_rows_reference`."""
    tensors = list(tensors)
    return _route(tensors[0], _launch_sumsq_rows, sumsq_rows_reference,
                  tensors)


def norm_of_rows(rows: torch.Tensor) -> torch.Tensor:
    """sqrt(Σ rows), a 0-dim fp32 tensor. CUDA: ``cfa_clip_norm``; CPU:
    :func:`norm_of_rows_reference`."""
    return _route(rows, _launch_norm_of_rows, norm_of_rows_reference, rows)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) in fp32 over ``tensors``, a 0-dim tensor on their
    device: :func:`norm_of_rows` of :func:`sumsq_rows`."""
    return norm_of_rows(sumsq_rows(tensors))


def clip_(grads: Sequence[torch.Tensor], norm: torch.Tensor,
          max_norm: float) -> None:
    """Every gradient ``g / norm · max_norm`` in place unless
    ``norm < max_norm``. CUDA: ``cfa_clip_scale``; CPU:
    :func:`clip_reference`."""
    grads = list(grads)
    if grads:
        _route(grads[0], _launch_clip, clip_reference, grads, norm,
               max_norm)


def adamspd_update(params: Sequence[torch.Tensor],
                   grads: Sequence[Optional[torch.Tensor]],
                   exp_avgs: Sequence[torch.Tensor],
                   exp_avg_sqs: Sequence[torch.Tensor],
                   max_exp_avg_sqs: Sequence[Optional[torch.Tensor]],
                   anchors: Sequence[torch.Tensor],
                   hypers: Sequence[AdamHyper]) -> torch.Tensor:
    """AdamSPD's first pass over the tensors (a None gradient is zeros; a
    None max is no amsgrad for that tensor): the moments and ``params`` in
    place; returns the ``[n, 3]`` fp32 sums. CUDA: ``cfa_adamspd_update``
    then ``cfa_adamspd_sums``; CPU: :func:`adamspd_update_reference`."""
    return _route(params[0], _launch_adamspd_update,
                  adamspd_update_reference, params, grads, exp_avgs,
                  exp_avg_sqs, max_exp_avg_sqs, anchors, hypers)


def adamspd_project(params: Sequence[torch.Tensor],
                    anchors: Sequence[torch.Tensor], sums: torch.Tensor,
                    weight_decays: Sequence[float]) -> None:
    """AdamSPD's second pass: each tensor whose ``sums`` row has a
    condition below 0 projected toward its anchor in place. CUDA:
    ``cfa_adamspd_project``; CPU: :func:`adamspd_project_reference`."""
    _route(params[0], _launch_adamspd_project, adamspd_project_reference,
           params, anchors, sums, weight_decays)
