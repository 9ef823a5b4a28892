"""The port's multi-tensor clip and AdamSPD (``clip_finegrained_alignment_
tpu_torch/ops/optimizer.py``, ``csrc/optimizer.cu``).

On the CPU the four functions are the plain versions: the per-tensor loops
the optimizer ran before, so ``AdamSPD.step`` and ``ClippedOptimizer.step``
are held bit for bit to a copy of the old per-tensor step (amsgrad, None
gradients, ``reduce_sums`` between the passes, two groups). The CUDA
branch is reached through monkeypatched launchers and library entries:
which launches a step makes, what each launcher hands its C entry, and
the tables it builds, read back by a numpy model of the kernels' chunk
addressing (``_Emulator``) that runs them on the CPU tensors' memory and
is held to the plain versions. ``chip_smoke.py`` phase 3 holds the
kernels themselves to the plain versions on the card.
"""

import contextlib
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu_torch.config import TrainConfig
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import optimizer as to
from clip_finegrained_alignment_tpu_torch.optim.adamspd import AdamSPD
from clip_finegrained_alignment_tpu_torch.optim.factory import make_optimizer

SOURCE = Path(to.__file__).resolve().parent.parent / "csrc" / "optimizer.cu"
SHAPES = [(6, 5), (7,), (), (0, 3), (1,), (4, 3, 2), (33,), (3, 1, 8)]


@torch.no_grad()
def _old_step(opt: AdamSPD) -> None:
    """``AdamSPD.step`` as it was: a loop a tensor, then a loop a tensor."""
    todo, rows = [], []
    for group in opt.param_groups:
        b1, b2 = group["betas"]
        eps, lr = group["eps"], group["lr"]
        for p in group["params"]:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            st = opt.state[p]
            if "step" not in st:
                st["step"] = 0
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
                if group["amsgrad"]:
                    st["max_exp_avg_sq"] = torch.zeros_like(p)
            st["step"] += 1
            count = np.float32(st["step"])
            bc1 = np.float32(1.0) - np.float32(b1) ** count
            bc2 = np.float32(1.0) - np.float32(b2) ** count
            m, v = st["exp_avg"], st["exp_avg_sq"]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(g * g, alpha=1 - b2)
            if group["amsgrad"]:
                torch.maximum(st["max_exp_avg_sq"], v,
                              out=st["max_exp_avg_sq"])
                v = st["max_exp_avg_sq"]
            denom = v.sqrt() / float(np.sqrt(bc2)) + eps
            pre = st["anchor"]
            condition = -(g * (p - pre)).sum()
            prev_sq = (p - pre).pow(2).sum()
            p.copy_(p - float(np.float32(lr) / bc1) * m / denom)
            rows.append(torch.stack([condition, (p - pre).pow(2).sum(),
                                     prev_sq]))
            todo.append((p, pre, group["weight_decay"]))
    if not todo:
        return
    sums = torch.stack(rows)
    if opt.reduce_sums is not None:
        sums = opt.reduce_sums(sums)
    for (p, pre, wd), (condition, curr_sq, prev_sq) in zip(
            todo, sums.unbind(0)):
        curr, prev = curr_sq.sqrt(), prev_sq.sqrt()
        safe = torch.where(curr == 0, torch.ones_like(curr), curr)
        ratio = torch.where(curr == 0, torch.zeros_like(curr),
                            (curr - prev) / safe).clamp(0.0, 1.0)
        projected = p - wd * ratio * (p - pre)
        p.copy_(torch.where(condition < 0, projected, p))


def _normal(rng, shape, scale=1.0) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rng.normal(scale=scale, size=shape),
                                       dtype=np.float32))


def _params(seed: int, shapes=SHAPES):
    """Parameters, anchors near them (one parameter on its anchor with a
    zero gradient every step: new == pre, the ``curr == 0`` guard)."""
    rng = np.random.default_rng(seed)
    params = [torch.nn.Parameter(_normal(rng, s)) for s in shapes]
    anchors = [p.detach() + _normal(rng, p.shape, 0.05) for p in params]
    anchors[1] = params[1].detach().clone()
    return params, anchors


def _grads(rng, params, none: bool, step: int):
    scale = 2.0 if step % 2 else 0.05
    out = [_normal(rng, p.shape, scale) for p in params]
    out[1] = torch.zeros_like(params[1])
    if none:
        out[0] = out[4] = None
    return out


def _adamspd(params, anchors, amsgrad, reduce_sums):
    # Two groups: the second with its own learning rate and decay.
    return AdamSPD([{"params": params[:5]},
                    {"params": params[5:], "lr": 3e-2, "weight_decay": 0.7}],
                   lr=1e-2, betas=(0.9, 0.98), eps=5e-6, weight_decay=0.2,
                   amsgrad=amsgrad, anchors=anchors, reduce_sums=reduce_sums)


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("none_grads", [False, True])
@pytest.mark.parametrize("amsgrad", [False, True])
def test_plain_step_equals_the_per_tensor_loop(amsgrad, none_grads, reduce):
    """Four steps of ``AdamSPD.step`` (the plain multi-tensor version) and
    of the old per-tensor step from the same state: parameters, moments,
    max v and steps bit-equal. ``reduce``: a ``reduce_sums`` that scales
    the rows (as ZeRO-1's all-reduce changes them) between the passes."""
    reduce_sums = (lambda rows: rows * torch.tensor([3.0, 0.5, 2.0])) \
        if reduce else None
    sides = []
    for _ in range(2):
        params, anchors = _params(0)
        sides.append((params, _adamspd(params, anchors, amsgrad,
                                       reduce_sums)))
    rng = np.random.default_rng(1)
    conditions = set()
    for step in range(4):
        grads = _grads(rng, sides[0][0], none_grads, step)
        opt = sides[1][1]
        conditions |= {bool((g * (p - opt.state[p]["anchor"])).sum() > 0)
                       for p, g in zip(sides[1][0], grads)
                       if g is not None and p.dim() and p.numel() > 1}
        for (params, opt), run in zip(sides, (AdamSPD.step, _old_step)):
            for p, g in zip(params, grads):
                p.grad = None if g is None else g.clone()
            run(opt)
        (new, opt_new), (old, opt_old) = sides
        for i, (a, b) in enumerate(zip(new, old)):
            assert torch.equal(a, b), f"step {step} param {i}"
            sa, sb = opt_new.state[a], opt_old.state[b]
            assert sorted(sa) == sorted(sb) and sa["step"] == sb["step"]
            for k in sa:
                if k != "step":
                    assert torch.equal(sa[k], sb[k]), f"step {step} {i} {k}"
    assert conditions == {False, True}    # both branches taken
    assert new[1].detach().equal(opt_new.state[new[1]]["anchor"])


@pytest.mark.parametrize("max_norm", [0.0, 1.0, 1e6])
def test_plain_clip_equals_the_per_tensor_loop(max_norm):
    """``ClippedOptimizer.step`` with AdamSPD on the CPU: the norm, the
    clipped gradients (what ``p.grad`` holds after the step) and the
    parameters equal the old code's global norm, ``where`` clip and
    per-tensor step, bit for bit."""
    cfg = TrainConfig(optimizer_type="adamspd", lr=1e-2, betas=(0.9, 0.98),
                      eps=5e-6, weight_decay=0.2, max_grad_norm=max_norm)
    params, anchors = _params(2)
    named = [(f"p{i}", p) for i, p in enumerate(params)]
    opt = make_optimizer(cfg, named, anchors={f"p{i}": a for i, a in
                                              enumerate(anchors)})
    old_params, old_anchors = _params(2)
    old = AdamSPD(old_params, lr=1e-2, betas=(0.9, 0.98), eps=5e-6,
                  weight_decay=0.2, anchors=old_anchors)
    rng = np.random.default_rng(3)
    for step in range(3):
        grads = _grads(rng, params, True, step)
        for ps in (params, old_params):
            for p, g in zip(ps, grads):
                p.grad = None if g is None else g.clone()
        norm = opt.step()
        gs = []
        for p in old_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            gs.append(p.grad)
        want = torch.stack([t.float().pow(2).sum() for t in gs]).sum().sqrt()
        if max_norm > 0:
            keep = want < max_norm
            for g in gs:
                g.copy_(torch.where(keep, g, g / want.to(g.dtype) * max_norm))
        _old_step(old)
        assert torch.equal(norm, want)
        for a, b in zip(params, old_params):
            assert torch.equal(a.grad, b.grad) and torch.equal(a, b)


def test_hyper_is_the_old_bias_correction():
    """``adam_hyper``: the step size and sqrt(bc2) as the old step took
    them, in fp32, for every count."""
    for step in (1, 2, 7, 1000):
        h = to.adam_hyper(3e-4, 0.9, 0.98, 1e-6, step)
        c = np.float32(step)
        bc1 = np.float32(1.0) - np.float32(0.9) ** c
        bc2 = np.float32(1.0) - np.float32(0.98) ** c
        assert h == (float(np.float32(3e-4) / bc1), float(np.sqrt(bc2)), 0.9,
                     0.98, 1e-6)


# ---------------------------------------------------------------------------
# The CUDA branch
# ---------------------------------------------------------------------------

def _cuda_branch(monkeypatch):
    """Route the CUDA branch on CPU tensors: the launchers become the plain
    versions, counting the launches the real ones make."""
    monkeypatch.setattr(to, "_device_kind", lambda t: "cuda")

    def counted(names, fn):
        def run(*args):
            for name in names:
                _build.LAUNCHES[name].add()
            return fn(*args)
        return run

    monkeypatch.setattr(to, "_launch_sumsq_rows", counted(
        (to.SUMSQ_KERNEL, to.ROWS_KERNEL), to.sumsq_rows_reference))
    monkeypatch.setattr(to, "_launch_norm_of_rows", counted(
        (to.NORM_KERNEL,), to.norm_of_rows_reference))
    monkeypatch.setattr(to, "_launch_clip", counted(
        (to.SCALE_KERNEL,), to.clip_reference))
    monkeypatch.setattr(to, "_launch_adamspd_update", counted(
        (to.UPDATE_KERNEL, to.SUMS_KERNEL), to.adamspd_update_reference))
    monkeypatch.setattr(to, "_launch_adamspd_project", counted(
        (to.PROJECT_KERNEL,), to.adamspd_project_reference))


def _counts():
    c = _build.launch_counts()
    return {n: c[n] for n in to.KERNELS}


@pytest.mark.parametrize("optimizer_type,max_norm,want", [
    ("adamspd", 1.0, (1, 1, 1, 1, 1, 1, 1)),
    ("adamspd", 0.0, (1, 1, 1, 0, 1, 1, 1)),
    ("adamw", 1.0, (1, 1, 1, 1, 0, 0, 0))])
def test_cuda_branch_launches_a_handful_a_step(optimizer_type, max_norm, want,
                                               monkeypatch):
    """A step on the CUDA branch: the norm's three launches, the clip's
    one (none without a clip), AdamSPD's three; AdamW's update is
    ``torch.optim.AdamW``'s. The CPU branch launches none, and both give
    the same parameters."""
    cfg = TrainConfig(optimizer_type=optimizer_type, lr=1e-2,
                      max_grad_norm=max_norm)
    results = []
    for cuda in (True, False):
        if cuda:
            _cuda_branch(monkeypatch)
        else:
            monkeypatch.undo()
        params, _ = _params(4)
        opt = make_optimizer(cfg, [(f"p{i}.weight", p)
                                   for i, p in enumerate(params)])
        rng = np.random.default_rng(5)
        _build.reset_launch_counts()
        for step in range(2):
            for p, g in zip(params, _grads(rng, params, True, step)):
                p.grad = g
            opt.step()
        got = _counts()
        assert got == {n: (2 * k if cuda else 0)
                       for n, k in zip(to.KERNELS, want)}
        results.append([p.detach().clone() for p in params])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_route_refuses_other_devices():
    t = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="no optimizer kernels"):
        to.global_norm([t])


@pytest.mark.parametrize("shape,dim,world", [
    ((8, 12), 1, 2), ((8, 12), 0, 4), ((6, 4, 10), 2, 5), ((6, 4, 10), 1, 2),
    ((197, 768), 1, 2), ((1, 6, 4), 2, 2), ((5, 1, 6), 2, 3)])
def test_runs_of_describes_shard_views(shape, dim, world):
    """ZeRO-1's shards (``x.chunk(world, dim)[rank]``): runs of ``inner``
    contiguous elements at a fixed stride, which read back the view."""
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    for rank in range(world):
        view = x.chunk(world, dim)[rank]
        runs, inner, stride = to.runs_of(view)
        assert runs * inner == view.numel()
        flat = x.reshape(-1)
        off = view.storage_offset()
        got = torch.cat([flat[off + r * stride: off + r * stride + inner]
                         for r in range(runs)])
        assert torch.equal(got, view.reshape(-1))


def test_runs_of_refuses_other_layouts():
    """A transpose, overlapping runs; a stepped slice is runs of one."""
    assert to.runs_of(torch.zeros(6, 4)[:, ::2]) == (12, 1, 2)
    x = torch.zeros(6, 4)
    for bad in (x.t(), torch.zeros(3).expand(4, 3)):
        with pytest.raises(ValueError):
            to.runs_of(bad)


def test_records_match_the_source():
    """``CHUNK`` and the three records' sizes are the source's."""
    src = SOURCE.read_text()
    assert f"constexpr int kChunk = {to.CHUNK};" in src
    for struct, dtype in (("AdamRec", to.ADAM_RECORD),
                          ("ProjectRec", to.PROJECT_RECORD),
                          ("GradRec", to.GRAD_RECORD)):
        assert f"sizeof({struct}) == {dtype.itemsize}" in src
        body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
        names = re.findall(r"(\w+)(?:,|;)", body)
        assert tuple(names) == dtype.names, struct


# -- the launchers and their tables -----------------------------------------

def _fma(a, b, c) -> np.ndarray:
    """a·b + c rounded once to fp32 (the product is exact in float64; the
    sum's rounding there shows in under one case in 2**29)."""
    return (a.astype(np.float64) * np.float64(b) + c).astype(np.float32)


def _mem(ptr: int, count: int) -> np.ndarray:
    """``count`` floats of this process's memory at ``ptr`` (a CPU
    tensor's), writable in place."""
    return np.ctypeslib.as_array((ctypes.c_float * count).from_address(ptr))


class _Emulator:
    """The library entries: each records its arguments and runs its kernel
    as numpy on the CPU memory the uploaded table points at, with the
    kernels' chunk addressing (a block a chunk, its tensor by the records'
    first chunks) and their arithmetic, elementwise in fp32."""

    def __init__(self):
        self.calls = {}
        self.tables = []
        self.by_ptr = {}

    def upload(self, records, device):
        self.tables.append(records.copy())
        table = torch.from_numpy(records.view(np.uint8).copy())
        self.by_ptr[table.data_ptr()] = (table, self.tables[-1])
        return table

    def lib(self, name):
        emu = self

        class Entry:
            argtypes = restype = None

            def __call__(self, *args):
                emu.calls.setdefault(name, []).append(args)
                getattr(emu, name)(*args[:-1])
                return 0

        return type("Lib", (), {f"cfa_{name}": Entry()})()

    def _records(self, table, n):
        return self.by_ptr[table][1][:n]

    @staticmethod
    def _chunks(rec, total):
        firsts = rec["first_chunk"]
        for b in range(total):
            t = int(np.searchsorted(firsts, b, side="right")) - 1
            r = rec[t]
            local = b - int(r["first_chunk"])
            run, part = divmod(local, int(r["run_chunks"]))
            start = part * to.CHUNK
            yield b, t, r, run, start, min(to.CHUNK, int(r["inner"]) - start)

    def clip_sumsq(self, table, n, total, partial):
        rec = self._records(table, n)
        out = _mem(partial, total)
        for b, _, r, run, start, ln in self._chunks(rec, total):
            g = _mem(int(r["g"]) + 4 * (run * int(r["g_stride"]) + start), ln)
            out[b] = np.sum(g.astype(np.float64) ** 2)

    def clip_rows(self, table, n, total, partial, rows):
        self._tensor_sums(table, n, total, partial, rows, 1)

    def clip_norm(self, rows, n, norm):
        _mem(norm, 1)[0] = np.sqrt(np.sum(_mem(rows, n), dtype=np.float64))

    def clip_scale(self, table, n, total, norm, max_norm):
        rec = self._records(table, n)
        nv = np.float32(_mem(norm, 1)[0])
        if nv < np.float32(max_norm):
            return
        for _, _, r, run, start, ln in self._chunks(rec, total):
            g = _mem(int(r["g"]) + 4 * (run * int(r["g_stride"]) + start), ln)
            g[:] = g / nv * np.float32(max_norm)

    def adamspd_update(self, table, n, total, partial):
        rec = self._records(table, n)
        out = _mem(partial, 3 * total).reshape(total, 3)
        f = np.float32
        for b, _, r, run, start, ln in self._chunks(rec, total):
            c = run * int(r["inner"]) + start
            p = _mem(int(r["p"]) + 4 * (run * int(r["p_stride"]) + start), ln)
            g = (np.zeros(ln, np.float32) if not r["g"] else
                 _mem(int(r["g"]) + 4 * (run * int(r["g_stride"]) + start),
                      ln))
            m, v, pre = (_mem(int(r[k]) + 4 * c, ln) for k in ("m", "v",
                                                                "pre"))
            m[:] = _fma(g, r["omb1"], m * r["b1"])
            v[:] = _fma(g * g, r["omb2"], v * r["b2"])
            vv = v
            if r["vmax"]:
                vm = _mem(int(r["vmax"]) + 4 * c, ln)
                vm[:] = np.maximum(vm, v)
                vv = vm
            denom = np.sqrt(vv) / r["sqrt_bc2"] + r["eps"]
            d0 = p - pre
            cond = -np.sum(g * d0, dtype=np.float64)
            prev = np.sum(d0 * d0, dtype=np.float64)
            p[:] = p - (r["step_size"] * m) / denom
            d1 = p - pre
            out[b] = (f(cond), f(np.sum(d1 * d1, dtype=np.float64)), f(prev))

    def _tensor_sums(self, table, n, total, partial, out, k):
        rec = self._records(table, n)
        parts = _mem(partial, k * max(total, 1))[:k * total].reshape(-1, k)
        out = _mem(out, k * n).reshape(n, k)
        ends = list(rec["first_chunk"][1:]) + [total]
        for t in range(n):
            out[t] = parts[rec["first_chunk"][t]:ends[t]].sum(0)

    def adamspd_sums(self, table, n, total, partial, sums):
        self._tensor_sums(table, n, total, partial, sums, 3)

    def adamspd_project(self, table, n, total, sums):
        rec = self._records(table, n)
        s = _mem(sums, 3 * n).reshape(n, 3)
        for _, t, r, run, start, ln in self._chunks(rec, total):
            cond, curr_sq, prev_sq = s[t]
            if not cond < 0:
                continue
            curr, prev = np.sqrt(curr_sq), np.sqrt(prev_sq)
            ratio = np.float32(0) if curr == 0 else np.clip(
                (curr - prev) / curr, 0, 1)
            coef = r["wd"] * ratio
            p = _mem(int(r["p"]) + 4 * (run * int(r["p_stride"]) + start), ln)
            pre = _mem(int(r["pre"]) + 4 * (run * int(r["inner"]) + start),
                       ln)
            p[:] = p - coef * (p - pre)


def _emulated(monkeypatch, chunk=8):
    """The CUDA branch's launchers over ``_Emulator`` entries, at a
    ``chunk`` small enough that the test tensors take several."""
    emu = _Emulator()
    monkeypatch.setattr(to, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(to, "CHUNK", chunk)
    monkeypatch.setattr(to, "_upload", emu.upload)
    monkeypatch.setattr(_build, "load", emu.lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("Stream", (), {"cuda_stream": 7})())
    _build.reset_launch_counts()
    return emu


def _views(seed, shard):
    """Parameters for the launchers; with ``shard``, each a ZeRO-1 shard
    of a larger tensor (a view split along its largest dimension), its
    gradient a view of the whole gradient the same way."""
    params, anchors = _params(seed, [(6, 20), (7,), (), (0, 3), (1,),
                                     (4, 3, 10), (33,), (3, 1, 40)])
    if not shard:
        return params, anchors, None
    wholes = [p.detach().repeat_interleave(2, dim=max(range(p.dim()),
                                                      key=lambda d: p.shape[d]))
              if p.dim() else p.detach().clone() for p in params]
    dims = [max(range(w.dim()), key=lambda d: w.shape[d]) if w.dim()
            else None for w in wholes]
    views = [w if d is None else w.chunk(2, d)[1]
             for w, d in zip(wholes, dims)]
    anchors = [v.detach().clone() + 0.05 for v in views]
    anchors[1] = views[1].clone()
    return views, anchors, dims


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("amsgrad", [False, True])
def test_launchers_tables_run_the_kernels_plain_step(amsgrad, shard,
                                                     monkeypatch):
    """Three AdamSPD steps through the CUDA branch's launchers, the
    entries emulated on the tables they were handed (``_Emulator``),
    against the plain versions from the same state: parameters, moments,
    max v and the sums within fp32 rounding (the emulator sums in another
    order), None gradients and an empty tensor among them; with ``shard``
    the parameters and gradients are ZeRO-1's views, whose runs the tables
    describe. Each launcher hands its entry the record count, the chunk
    count and the stream, and counts one launch."""
    rng = np.random.default_rng(11)
    sides = []
    for _ in range(2):
        params, anchors, dims = _views(6, shard)
        opt = AdamSPD(params, lr=1e-2, betas=(0.9, 0.98), eps=5e-6,
                      weight_decay=0.4, amsgrad=amsgrad, anchors=anchors)
        sides.append((params, opt))
    emu = _emulated(monkeypatch)
    for step in range(3):
        grads = [_normal(rng, p.shape, 0.3) for p in sides[0][0]]
        grads[1] = torch.zeros_like(grads[1])
        grads[0] = grads[4] = None
        for (params, opt), cuda in zip(sides, (True, False)):
            monkeypatch.setattr(to, "_device_kind",
                                lambda t, c=cuda: "cuda" if c else "cpu")
            for i, (p, g) in enumerate(zip(params, grads)):
                if g is not None and shard and dims[i] is not None:
                    whole = torch.zeros(p.shape[:dims[i]]
                                        + (2 * p.shape[dims[i]],)
                                        + p.shape[dims[i] + 1:])
                    g_view = whole.chunk(2, dims[i])[1]
                    g_view.copy_(g)
                    g = g_view
                p.grad = g
            opt.step()
        (kp, kopt), (pp, popt) = sides
        for i, (a, b) in enumerate(zip(kp, pp)):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=2e-6,
                                       atol=1e-7, msg=f"step {step} p{i}")
            for k, x in popt.state[b].items():
                if k != "step":
                    torch.testing.assert_close(kopt.state[a][k], x,
                                               rtol=2e-6, atol=1e-9)
    n = len(sides[0][0])
    rec = emu.tables[0]
    assert rec.dtype == to.ADAM_RECORD and len(rec) == n
    kp, kopt = sides[0]
    assert list(rec["p"]) == [p.data_ptr() for p in kp]
    assert rec["g"][0] == 0 and rec["g"][4] == 0      # None: a null pointer
    assert list(rec["pre"]) == [kopt.state[p]["anchor"].data_ptr()
                                for p in kp]
    numel = [p.numel() for p in kp]
    # (an empty tensor's pointers are null)
    assert ((rec["vmax"] != 0) == amsgrad)[np.array(numel) > 0].all()
    h = to.adam_hyper(1e-2, 0.9, 0.98, 5e-6, 1)
    assert rec["step_size"][0] == np.float32(h.step_size)
    assert rec["omb1"][0] == np.float32(1 - 0.9) \
        and rec["omb2"][0] == np.float32(1 - 0.98)
    chunks = [-(-rec["inner"][i] // 8) * (numel[i] // max(rec["inner"][i], 1))
              for i in range(n)]
    assert list(rec["first_chunk"]) == list(np.cumsum(chunks) - chunks)
    total = int(sum(chunks))
    update = emu.calls[to.UPDATE_KERNEL][0]
    assert update[1:3] == (n, total) and update[-1] == 7
    assert _counts() == {to.SUMSQ_KERNEL: 0, to.ROWS_KERNEL: 0,
                         to.NORM_KERNEL: 0, to.SCALE_KERNEL: 0,
                         to.UPDATE_KERNEL: 3, to.SUMS_KERNEL: 3,
                         to.PROJECT_KERNEL: 3}
    if shard:
        assert any(r > 1 for r in (numel[i] // max(rec["inner"][i], 1)
                                   for i in range(n)))


@pytest.mark.parametrize("max_norm", [1e-3, 1e6])
def test_clip_launchers_tables_run_the_kernels_plain_clip(max_norm,
                                                          monkeypatch):
    """``global_norm`` and ``clip_`` through the launchers with emulated
    entries against the plain versions: the rows and the norm within fp32
    rounding, the clipped gradients (clipped, or left as they were) equal
    given the same norm; the sumsq, rows and norm entries one launch each,
    the scale entry handed the norm's pointer and the max."""
    rng = np.random.default_rng(12)
    grads = [_normal(rng, s) for s in [(6, 20), (7,), (), (0, 3), (33,),
                                       (3, 1, 40)]]
    view = torch.zeros(6, 40).chunk(2, 1)[1]
    view.copy_(_normal(rng, (6, 20)))
    grads.append(view)
    plain = [g.clone() for g in grads]
    want = to.global_norm_reference(plain)
    to.clip_reference(plain, want, max_norm)
    emu = _emulated(monkeypatch)
    norm = to.global_norm(grads)
    torch.testing.assert_close(norm, to.global_norm_reference(grads),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(to.sumsq_rows(grads),
                               to.sumsq_rows_reference(grads), rtol=1e-6,
                               atol=0)
    to.clip_(grads, want, max_norm)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    scale = emu.calls[to.SCALE_KERNEL][0]
    assert scale[3] == want.data_ptr() and scale[4] == max_norm
    assert _counts() == {to.SUMSQ_KERNEL: 2, to.ROWS_KERNEL: 2,
                         to.NORM_KERNEL: 1, to.SCALE_KERNEL: 1,
                         to.UPDATE_KERNEL: 0, to.SUMS_KERNEL: 0,
                         to.PROJECT_KERNEL: 0}


def test_launchers_refuse_what_the_kernels_do_not_take(monkeypatch):
    _emulated(monkeypatch)
    p = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="fp32"):
        to.global_norm([p, torch.zeros(3, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="None"):
        to.clip_([p, None], torch.tensor(1.0), 1.0)
    with pytest.raises(ValueError, match="scalar norm"):
        to.clip_([p], torch.tensor([1.0]), 1.0)
    with pytest.raises(ValueError):
        to.global_norm([torch.zeros(4, 6).t()])
    h = to.adam_hyper(1e-3, 0.9, 0.99, 1e-8, 1)
    with pytest.raises(ValueError, match="contiguous"):
        to.adamspd_update([p], [None], [torch.zeros(3, 4).t()],
                          [torch.zeros(4, 3)], [None], [torch.zeros(4, 3)],
                          [h])
    assert not any(_counts().values())
