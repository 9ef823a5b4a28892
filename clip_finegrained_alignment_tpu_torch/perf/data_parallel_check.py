"""Data parallelism held to one process: W ranks (``parallel/launch.py``)
each step SPARC + AdamSPD (its anchors :func:`anchors_off` the weights)
on its rows of one global batch in each mode, and rank 0 holds every mode
to a one-process oracle on the same batch:

* ``local`` (DDP) against the mean of the per-shard steps: each shard's
  gradients and losses in one process, averaged, then one optimizer step;
* ``global``, ``zero1`` and ``fsdp`` (global negatives) against one
  process stepping the whole global batch (the replicated layout).

Three steps each: every step's loss and gradient norm, the first step's
per-tensor gradient cosines, the per-tensor cosine and relative error of
the parameters' whole update, and the relative error of the first
step's update. ``zero1`` and ``fsdp`` are also held to ``global`` on the
same ranks (``vs_replicated``): their first step starts from the same
gradients, so its update parts only where the optimizer reads a shard
alone (AdamSPD's per-tensor sums, FSDP's norm). Each rank also reports its
launches of the port's kernels in its first step, its step ms after the
first step and its peak memory. :func:`probe_collectives` records which
collectives the backend runs on the device's tensors, and
:func:`one_rank_identity` holds one step of a one-rank mesh (global
negatives, ZeRO-1) to the step with no mesh, bit for bit.

``chip_smoke.py`` phase 10 runs these on the card at ViT-B/16 full width,
two ranks on one GPU over gloo. On the CPU, at fewer layers, this module
is the study that set phase 10's limits::

    python -m clip_finegrained_alignment_tpu_torch.perf.data_parallel_check \\
        --device cpu --layers 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Dict, List, Optional

import numpy as np

from ._measure import synchronize

# The learning rate, and the scale of AdamSPD's anchors' offset from the
# weights (:func:`anchors_off`).
LR = 1e-5
MODES = {"local": {},
         "global": {"global_negatives": True},
         "zero1": {"global_negatives": True, "zero1": True},
         "fsdp": {"global_negatives": True, "fsdp": True}}


def model_config(name: str, layers: Optional[int]):
    """The named CLIP config, both towers cut to ``layers`` if given."""
    from ..config import CLIPConfig
    cfg = CLIPConfig.from_name(name)
    if layers is None:
        return cfg
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_layers=layers),
        text=dataclasses.replace(cfg.text, num_layers=layers))


def train_config(mode: str, B: int, accum: int, dtype: str):
    from ..config import TrainConfig
    return TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                       batch_size=B, gradient_accumulation_steps=accum,
                       inverse_temperature=0.07, lr=LR,
                       use_amp=dtype == "bfloat16", **MODES[mode])


def global_batch(cfg, accum: int, B: int, seed: int) -> dict:
    """Normal pixels and random ids with EOS last (``bench.py``'s batch);
    a few captions end early in padding (SPARC's mask)."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    T = t.max_position_embeddings
    ids = rng.integers(1, t.vocab_size - 2,
                       size=(accum, B, T)).astype(np.int32)
    ids[..., -1] = t.eos_token_id
    for j, cut in ((0, T // 2), (1, 3 * T // 4), (B - 1, T // 8 + 1)):
        ids[:, j, T - cut] = t.eos_token_id
        ids[:, j, T - cut + 1:] = t.pad_token_id
    pix = rng.normal(size=(accum, B, v.image_size, v.image_size, 3)
                     ).astype(np.float32)
    return {"pixel_values": pix, "input_ids": ids}


def anchors_off(sd: dict, seed: int, scale: float = LR) -> dict:
    """AdamSPD anchors ``scale`` off the weights ``sd`` (normal, from a
    seed). With anchors on the weights the first step projects nothing
    and later steps point away from the anchor on every shard alike, so a
    shard's partial sums decide as the whole tensor's would. At one step's
    scale (the learning rate) −⟨g, p − pre⟩ has a random sign that a
    shard's part of it often does not share, and the projection ratio is
    well-conditioned: a fault that reads a shard's sums alone moves the
    first step's update. (At 0.02, far from a step, the ratio is a small
    difference of two large sums, and their order alone moves it.)"""
    import torch
    rng = np.random.default_rng(seed + 1000)
    return {k: v + torch.from_numpy(rng.normal(
        scale=scale, size=tuple(v.shape)).astype(np.float32)).to(v.dtype)
        for k, v in sd.items()}


def _whole_grads(model, opt) -> Dict[str, "torch.Tensor"]:
    """name → fp32 CPU gradient of every parameter (FSDP: the shards'
    mean gradients gathered; every rank takes part)."""
    import torch
    from ..parallel import collectives as C
    layout = opt.layout
    grads = {n: p.grad for n, p in model.named_parameters()}
    if layout is not None and layout.fsdp:
        split = [i for i, d in enumerate(layout.dims) if d is not None]
        whole = C.all_gather_shards([layout.shards[i].grad for i in split],
                                    [layout.dims[i] for i in split])
        for i, w in zip(split, whole):
            grads[layout.names[i]] = w
    return {n: (g if g is not None else torch.zeros(1)).detach().float().cpu()
            for n, g in grads.items()}


def _whole_params(model, opt) -> Dict[str, "torch.Tensor"]:
    layout = opt.layout
    params = layout.full_params() if layout is not None else \
        {n: p.detach() for n, p in model.named_parameters()}
    return {n: p.float().cpu().clone() for n, p in params.items()}


def oracle(cfg, tcfg, sd, anchors, batch, steps: int, W: int,
           device) -> dict:
    """The one-process trajectory the ranks are held to, from weights
    ``sd`` and AdamSPD ``anchors``: with global negatives the whole global
    batch a step; with local negatives the mean of the W shards' gradients
    and losses a step."""
    import torch
    from ..core.precision import compute_dtype
    from ..models import clip as m
    from ..optim.factory import make_optimizer
    from ..train.engine import accumulate_grads, make_train_step
    model = m.build_train_model(cfg, sd, device=device)
    opt = make_optimizer(tcfg, model.named_parameters(), anchors=anchors)
    dev = {k: torch.from_numpy(x).to(device) for k, x in batch.items()}
    if tcfg.global_negatives:
        step = make_train_step(tcfg, cfg, model, opt)
    else:
        params = list(model.parameters())
        per = dev["input_ids"].shape[1] // W

        def step(b):
            total, losses = None, None
            for r in range(W):
                m_ = accumulate_grads(model, {k: x[:, r * per:(r + 1) * per]
                                              for k, x in b.items()},
                                      tcfg, cfg, dtype=compute_dtype(tcfg))
                g = [p.grad.clone() if p.grad is not None
                     else torch.zeros_like(p) for p in params]
                total = g if total is None else [a + c
                                                 for a, c in zip(total, g)]
                losses = m_ if losses is None else {
                    k: losses[k] + m_[k] for k in losses}
            for p, g in zip(params, total):
                p.grad = g * (1.0 / W)
            out = {k: v * (1.0 / W) for k, v in losses.items()}
            out["grad_norm"] = opt.step()
            return out
    metrics, grads, first = [], None, None
    for s in range(steps):
        metrics.append({k: float(v) for k, v in step(dev).items()})
        if s == 0:
            grads = _whole_grads(model, opt)
            first = _whole_params(model, opt)
    return {"metrics": metrics, "grads": grads, "first_params": first,
            "params": _whole_params(model, opt)}


def compare(run: dict, ref: dict, initial: Dict[str, "torch.Tensor"],
            device=None) -> dict:
    """Per-step loss and gradient-norm relative differences (the largest),
    the smallest per-tensor cosine of the first step's gradients and of
    the whole update ``params − initial``, and the largest per-tensor
    ‖update − ref's update‖ / ‖ref's update‖ of the whole update and of
    the first step's (float64, on ``device``: one tensor at a time is
    copied there from the host copies). A key projection's
    bias gradient is zero by math (softmax ignores a constant added to a
    row's scores): it is rounding noise on both sides, left out of the
    cosines and reported as its share of the gradient norm."""
    import torch

    def flat(x):
        return x.to(device, torch.float64).flatten()

    def cos(a, b):
        return (a @ b / (a.norm() * b.norm())).item()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    loss_rel = max(abs(a["total_loss"] - b["total_loss"])
                   / abs(b["total_loss"])
                   for a, b in zip(run["metrics"], ref["metrics"]))
    norm_rel = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                   for a, b in zip(run["metrics"], ref["metrics"]))
    g_cos, u_cos, u_rel, f_rel, noise = {}, {}, {}, {}, 0.0
    n0 = ref["metrics"][0]["grad_norm"]
    for n, want in ref["grads"].items():
        if n.endswith("self_attn.k_proj.bias"):
            noise = max(noise, run["grads"][n].norm().item() / n0,
                        want.norm().item() / n0)
            continue
        if want.any():
            g_cos[n] = cos(flat(run["grads"][n]), flat(want))
        init = flat(initial[n])
        upd = flat(ref["params"][n]) - init
        if upd.any():
            got = flat(run["params"][n]) - init
            u_cos[n] = cos(got, upd)
            u_rel[n] = rel(got, upd)
        upd = flat(ref["first_params"][n]) - init
        if upd.any():
            f_rel[n] = rel(flat(run["first_params"][n]) - init, upd)
    gw, uw = min(g_cos, key=g_cos.get), min(u_cos, key=u_cos.get)
    rw, fw = max(u_rel, key=u_rel.get), max(f_rel, key=f_rel.get)
    return {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
            "min_grad_cosine": g_cos[gw], "min_grad_cosine_tensor": gw,
            "min_update_cosine": u_cos[uw], "min_update_cosine_tensor": uw,
            "max_update_rel": u_rel[rw], "max_update_rel_tensor": rw,
            "max_first_update_rel": f_rel[fw],
            "max_first_update_rel_tensor": fw,
            "k_proj_bias_grad_share_of_norm": noise,
            "losses": [m["total_loss"] for m in run["metrics"]],
            "oracle_losses": [m["total_loss"] for m in ref["metrics"]],
            "grad_norms": [m["grad_norm"] for m in run["metrics"]],
            "oracle_grad_norms": [m["grad_norm"] for m in ref["metrics"]]}


def probe_collectives(device) -> dict:
    """Each collective on this rank's ``device`` tensors: "ok" when it ran
    and gave the right values, else the error. The port uses all_reduce
    (SUM, MAX), all_gather_into_tensor, reduce_scatter_tensor, broadcast
    and barrier; the list all_to_all, all_to_all_single and
    all_reduce_coalesced are probed for the record."""
    import torch
    import torch.distributed as dist
    W, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(2 * W, dtype=torch.float32, device=device) + 100 * r
    ranks = torch.arange(W, dtype=torch.float32, device=device)
    total = (torch.arange(2 * W, dtype=torch.float32, device=device) * W
             + 100 * ranks.sum())

    def run(fn):
        try:
            ok = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return "ok" if ok else "wrong values"
        except Exception as e:  # recorded: the probe's result
            return f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"

    def all_reduce(op, want):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return torch.equal(y, want)

    def gather():
        out = x.new_empty(2 * W * W)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out.view(W, -1)[:, 0], 100 * ranks)

    def reduce_scatter():
        out = x.new_empty(2)
        dist.reduce_scatter_tensor(out, x)
        return torch.equal(out, total[2 * r:2 * r + 2])

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return torch.equal(y, x - 100 * r)

    def to_all_list():
        outs = [x.new_empty(2) for _ in range(W)]
        dist.all_to_all(outs, list(x.chunk(W)))
        return True

    def to_all_single():
        out = x.new_empty(2 * W)
        dist.all_to_all_single(out, x)
        return True

    def coalesced():
        dist.all_reduce_coalesced([x.clone(), x.clone()])
        return True

    return {"backend": dist.get_backend(), "device": str(device),
            "used": {"all_reduce_sum": run(lambda: all_reduce(
                         dist.ReduceOp.SUM, total)),
                     "all_reduce_max": run(lambda: all_reduce(
                         dist.ReduceOp.MAX, x - 100 * r + 100 * (W - 1))),
                     "all_gather_into_tensor": run(gather),
                     "reduce_scatter_tensor": run(reduce_scatter),
                     "broadcast": run(broadcast),
                     "barrier": run(lambda: dist.barrier() or True)},
            "unused": {"all_to_all": run(to_all_list),
                       "all_to_all_single": run(to_all_single),
                       "all_reduce_coalesced": run(coalesced)}}


def rank_modes(model_name: str, layers: Optional[int], dtype: str, B: int,
               accum: int, seed: int, steps: int,
               modes: List[str], save_global: Optional[str] = None) -> dict:
    """On every rank (the group is up): each mode's ``steps`` on this
    rank's rows of the global batch ``[accum, W·B, …]``, AdamSPD's
    anchors :func:`anchors_off` the weights; on rank 0 also
    the oracles and the comparisons. Returns per mode: metrics, first-step
    launches, step ms, peak memory, and on rank 0 ``vs_oracle`` and, for
    ``zero1`` and ``fsdp`` after ``global``, ``vs_replicated``: the
    sharded layout against the replicated one on the same ranks, whose
    gradients are the same computation, so that only the optimizer's
    reading of a shard (AdamSPD's per-tensor sums, FSDP's norm) can part
    them. ``save_global``: rank 0 also writes the weights, the anchors and
    the global-negatives oracle there, in
    ``model_parallel_check.prepare``'s format, for a later run on the
    same global batch to read."""
    import torch
    from ..models import clip as m
    from ..models.convert import random_params, state_dict_from_jax
    from ..ops import _build
    from ..optim.factory import make_optimizer
    from ..parallel import mesh as pmesh
    from ..train.engine import make_train_step

    mesh = pmesh.make_mesh()
    device = mesh.device
    cfg = model_config(model_name, layers)
    sd = state_dict_from_jax(random_params(cfg, seed), cfg)
    anchors = {k: v.to(device) for k, v in anchors_off(sd, seed).items()}
    batch = global_batch(cfg, accum, mesh.data * B, seed)
    initial = {k: v.float().clone() for k, v in sd.items()}
    refs = {}
    if mesh.rank == 0:
        for neg in sorted({"local" if mode == "local" else "global"
                           for mode in modes}):
            refs[neg] = oracle(cfg, train_config(neg, mesh.data * B, accum,
                                                 dtype),
                               sd, anchors, batch, steps, mesh.data, device)
        if save_global is not None:
            torch.save({"sd": sd, "ref": refs["global"],
                        "anchors": {k: v.cpu() for k, v in anchors.items()}},
                       save_global)
    local = {k: torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for k, x in pmesh.shard_batch(batch, mesh,
                                           accum_axis=True).items()}
    out, replicated = {}, None
    for mode in modes:
        tcfg = train_config(mode, mesh.data * B, accum, dtype)
        model = m.build_train_model(cfg, sd, device=device)
        opt = make_optimizer(tcfg, model.named_parameters(),
                             anchors=anchors, mesh=mesh)
        step = make_train_step(tcfg, cfg, model, opt, mesh=mesh)
        metrics, ms, launches, grads, first = [], [], None, None, None
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        for s in range(steps):
            synchronize(device)
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            got = step(local)
            synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if s == 0:
                launches = _build.launch_counts()
                grads = _whole_grads(model, opt)
                first = _whole_params(model, opt)
            metrics.append({k: float(v) for k, v in got.items()})
        run = {"metrics": metrics, "grads": grads, "first_params": first,
               "params": _whole_params(model, opt)}
        res = {"metrics": metrics, "launches": launches,
               "step_ms": ms[1:] if len(ms) > 1 else ms,
               "peak_memory_gb": torch.cuda.max_memory_allocated(device)
               / 1e9 if device.type == "cuda" else None}
        if mesh.rank == 0:
            res["vs_oracle"] = compare(
                run, refs["local" if mode == "local" else "global"],
                initial, device)
            if mode == "global":
                replicated = run
            elif replicated is not None:
                res["vs_replicated"] = compare(run, replicated, initial,
                                               device)
        del model, opt, step, run
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[mode] = res
    return out


def one_rank_identity(model_name: str, layers: Optional[int], dtype: str,
                      B: int, accum: int, seed: int) -> dict:
    """On a one-rank group: one global-negatives ZeRO-1 step through
    ``make_train_step(mesh=…)`` and the same step with ``mesh=None``, from
    the same weights on the same batch. Every collective is an identity,
    so metrics, gradients and updated parameters must be bit-equal."""
    import torch
    from ..models import clip as m
    from ..models.convert import random_params, state_dict_from_jax
    from ..optim.factory import make_optimizer
    from ..parallel import mesh as pmesh
    from ..train.engine import make_train_step

    mesh = pmesh.make_mesh()
    cfg = model_config(model_name, layers)
    sd = state_dict_from_jax(random_params(cfg, seed), cfg)
    batch = {k: torch.from_numpy(x).to(mesh.device)
             for k, x in global_batch(cfg, accum, B, seed).items()}
    tcfg = train_config("zero1", B, accum, dtype)
    runs = []
    for with_mesh in (None, mesh):
        model = m.build_train_model(cfg, sd, device=mesh.device)
        opt = make_optimizer(tcfg, model.named_parameters(), mesh=with_mesh)
        metrics = make_train_step(tcfg, cfg, model, opt, mesh=with_mesh)(
            batch)
        runs.append(({k: v.item() for k, v in metrics.items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
                     {n: p.detach().clone()
                      for n, p in model.named_parameters()}))
        del model, opt
    (m0, g0, p0), (m1, g1, p1) = runs
    return {"backend": mesh.backend, "world": mesh.data,
            "metrics": m1, "metrics_equal": m0 == m1,
            "grads_equal": g0.keys() == g1.keys()
            and all(torch.equal(g0[k], g1[k]) for k in g0),
            "params_equal": all(torch.equal(p0[k], p1[k]) for k in p0)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="ViT-B/16")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=16, help="rows a rank")
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from ..parallel.launch import spawn
    env = {"LOCAL_RANK": "0"} if args.device == "cuda" else {}
    ranks = spawn(rank_modes, args.ranks,
                  (args.model, args.layers, args.dtype, args.batch,
                   args.accum, args.seed, args.steps, list(MODES)),
                  timeout_s=3000, device=args.device, backend="gloo",
                  env=env)
    for mode, res in ranks[0].items():
        print(json.dumps({"mode": mode, "layers": args.layers,
                          "dtype": args.dtype, **res["vs_oracle"],
                          "step_ms": res["step_ms"]}))
        if "vs_replicated" in res:
            print(json.dumps({"mode": mode, "vs": "replicated",
                              **res["vs_replicated"]}))
        same = all(r[mode]["metrics"] == res["metrics"] for r in ranks)
        print(json.dumps({"mode": mode, "ranks_agree": same}))
        if not all(math.isfinite(x["total_loss"]) for x in res["metrics"]):
            raise SystemExit(f"{mode}: a loss is not finite")


if __name__ == "__main__":
    main()
