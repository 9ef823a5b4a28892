"""Tensor and pipeline parallelism held to one process: W ranks
(``parallel/launch.py``) laid out as ``data × model × pipe`` each step
SPARC + AdamSPD with global negatives (its anchors
``data_parallel_check.anchors_off`` the weights) on their data
coordinate's rows of one global batch, and rank 0 holds every mode to a
one-process oracle stepping the whole global batch
(``data_parallel_check.oracle``):

* ``tp2``: 1 x 2 x 1, Megatron TP (H/2 heads a rank);
* ``pp2``: 1 x 1 x 2, GPipe with ``MICRO`` microbatches;
* ``tp2pp2``: 1 x 2 x 2, TP inside each stage;
* ``dp2tp2``: 2 x 2 x 1 with FSDP over the data ranks;
* ``tp2-int8`` and ``dp2tp2-int8``: ``tp2`` and ``dp2tp2`` with
  ``quant="int8"`` (every projection int8, the scales JAX's GSPMD step
  takes: ``ops/quant.py``), held to a one-process oracle that runs
  ``int8`` too, from the same weights; ``dp2-int8``, two data ranks of
  global negatives with ZeRO-1 in int8 (the int8 wgrad's scales over
  both ranks' rows, ROADMAP C7).

Three steps each: every step's loss and gradient norm, the first step's
per-tensor gradient cosines and relative errors, and the per-tensor
cosine and relative error of the parameters' whole update and of the
first step's update (``data_parallel_check.compare``, plus
``max_grad_rel`` and, for the int8 modes, the quantized tests' element
readings of the first step: ``first_loss_rel``, ``first_grad_norm_rel``
and ``first_update_off_share``, the share of the first update's elements
more than 2e-3 of their tensor's largest update away from the oracle's). Against the oracle, bf16 moves every gradient a
little (a rank's GEMMs are other shapes than one process's), and
AdamSPD's first update turns that into whole steps of the learning rate;
so the first update is also held to a replay (``replay_first_update_rel``):
one process's optimizer stepping the run's own first-step gradients,
gathered whole, from the same weights and anchors. There only the
distributed optimizer's reading of the tensors' parts (AdamSPD's
per-tensor sums, the norm) can part the two. Each rank also reports its
launches of the port's kernels in its first step, its step ms after the
first step and its peak memory.

:data:`FAULTS` are the faults the gates are for (trouble spots a and b):
``pipe_summed_post`` sums the gradients of the parameters after the
pipeline over the stages (they are already equal there), ``tp_sums_alone``
lets AdamSPD read a tensor-parallel shard's sums alone, and
``norm_counts_tp`` counts a tensor whole on every model rank tp times in
the gradient norm, and ``quant_shard_scales`` takes every int8 scale from
this rank's part alone (a TP layer's split contraction, the int8 wgrad's
rows under global negatives and SP), as the port did before the scales
took their groups. :func:`inject` puts one into this process's port.

The sequence-parallel modes and faults (``sp2``, ``sp2-ring``,
``dp2sp2-ring``) are ``sequence_parallel_check.py``'s; :func:`rank_modes`
and :func:`inject` take them too (:func:`mode_spec`, :func:`all_faults`).

The int8 modes are the sequence-parallel study's ``sp2-int8`` too.

``chip_smoke.py`` phase 11 runs the modes on the card at ViT-B/16 full
width, ranks sharing one GPU over gloo. On the CPU, at fewer layers (an
even count: the pipeline cuts each tower in two), this module is the
study that set phase 11's limits::

    python -m clip_finegrained_alignment_tpu_torch.perf.model_parallel_check \\
        --device cpu --layers 2 [--fault NAME]
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, List, Optional

from . import data_parallel_check as dpc
from ._measure import synchronize

# GPipe microbatches of a train microbatch (phase 11: B = 32 rows, 8 a
# pipeline microbatch).
MICRO = 4
MODES = {"tp2": ({"data": 1, "model": 2, "pipe": 1}, {}),
         "pp2": ({"data": 1, "model": 1, "pipe": 2}, {}),
         "tp2pp2": ({"data": 1, "model": 2, "pipe": 2}, {}),
         "dp2tp2": ({"data": 2, "model": 2, "pipe": 1}, {"fsdp": True}),
         "tp2-int8": ({"data": 1, "model": 2, "pipe": 1}, {"quant": "int8"}),
         "dp2-int8": ({"data": 2, "model": 1, "pipe": 1},
                      {"zero1": True, "quant": "int8"}),
         "dp2tp2-int8": ({"data": 2, "model": 2, "pipe": 1},
                         {"fsdp": True, "quant": "int8"})}
# The element readings of a quantized first step (tests/test_torch_train.py's
# quantized steps): an update element is off when it lies more than this
# share of its tensor's largest update from the oracle's.
OFF_SHARE_OF_MAX = 2e-3


def tp_sum_bytes(cfg, rows: int, accum: int, quant: str = "none") -> dict:
    """What one rank of ``1 x 2 x 1`` tensor parallelism hands gloo's
    all-reduces in one train step of ``accum`` microbatches of ``rows``
    rows, by the model's shapes (the all-reduces' operands, each once):
    in bf16 the activations' partial sums, 2 bytes an element, two a
    layer forward (``reduce_from_model``) and two backward
    (``copy_to_model``); in ``int8`` / ``switchback`` int32 sums, 4 bytes
    an element, the row-parallel forwards (out, fc2) and the
    column-parallel dgrads (q, k, v, fc1: none reach ``copy_to_model``),
    and the scale vectors' MAX (fp32: x's and W's, g's and W's)."""
    sums = maxes = 0
    for tower, S in ((cfg.vision, cfg.vision.seq_len),
                     (cfg.text, cfg.text.max_position_embeddings)):
        M, D = rows * S, tower.hidden_size
        if quant == "none":
            sums += tower.num_layers * 4 * M * D * 2
        else:
            sums += tower.num_layers * 6 * M * D * 4
            maxes += tower.num_layers * 6 * (M + D) * 4
    return {"sum_bytes": sums * accum, "max_bytes": maxes * accum}


def mode_spec(mode: str):
    """(mesh fields, config fields) of ``mode``: one of :data:`MODES` or
    of ``sequence_parallel_check.MODES``."""
    if mode in MODES:
        return MODES[mode]
    from .sequence_parallel_check import MODES as SP_MODES
    return SP_MODES[mode]


def quant_of(mode: str) -> str:
    """The mode's ``TrainConfig.quant`` (its oracle runs the same)."""
    return mode_spec(mode)[1].get("quant", "none")


def ranks_of(mode: str) -> int:
    mesh, _ = mode_spec(mode)
    return mesh["data"] * mesh["model"] * mesh["pipe"]


def train_config(mode: str, B: int, accum: int, dtype: str):
    """The mode's config: ``data_parallel_check``'s global-negatives
    SPARC + AdamSPD config on the mode's mesh."""
    import dataclasses
    from ..config import MeshConfig
    mesh, extra = mode_spec(mode)
    return dataclasses.replace(
        dpc.train_config("global", B, accum, dtype),
        mesh=MeshConfig(**mesh), pipeline_microbatches=MICRO, **extra)


# ---------------------------------------------------------------------------
# The faults
# ---------------------------------------------------------------------------

def _pipe_summed_post():
    from ..parallel import sharding_rules
    from ..train import engine
    engine.before_pipeline = lambda n: sharding_rules.layer_index(n) is None


def _tp_sums_alone():
    from ..parallel.zero import ShardLayout
    ShardLayout.reduce_sums = lambda self, rows, order: rows


def _norm_counts_tp():
    import torch
    from ..parallel.zero import ShardLayout

    def grad_norm(self):
        grads = [s.grad for s in self.shards] if self.fsdp else \
            [p.grad for p in self.params]
        sq = torch.stack([g.float().pow(2).sum() for g in grads])
        m = self.mesh
        keep = torch.tensor([
            ((self.fsdp and self.dims[i] is not None) or m.data_rank == 0)
            and (self.staged[i] or m.pipe_rank == 0)
            for i in range(len(grads))], device=sq.device)
        index = torch.tensor(self.rows, device=sq.device)
        buf = sq.new_zeros(len(self.whole))
        buf.index_copy_(0, index, torch.where(keep, sq, 0.0))
        from ..parallel import collectives as C
        return C.all_reduce_sum(buf).sum().sqrt()
    ShardLayout.grad_norm = grad_norm


def _quant_shard_scales():
    from ..models import clip
    # TP layers as without quant (copy_to_model, reduce_from_model) around
    # products that quantize this rank's part with its own scales, and
    # the int8 wgrad over this rank's rows alone.
    clip._quantized = lambda quant: False


FAULTS = {"pipe_summed_post": _pipe_summed_post,
          "tp_sums_alone": _tp_sums_alone,
          "norm_counts_tp": _norm_counts_tp,
          "quant_shard_scales": _quant_shard_scales}


def all_faults() -> dict:
    """:data:`FAULTS` and ``sequence_parallel_check.FAULTS``."""
    from .sequence_parallel_check import FAULTS as SP_FAULTS
    return {**FAULTS, **SP_FAULTS}


def inject(fault: Optional[str]) -> None:
    """Put fault ``fault`` (a key of :func:`all_faults`) into this
    process's port; None leaves it as it is."""
    if fault is not None:
        all_faults()[fault]()


# ---------------------------------------------------------------------------
# The modes
# ---------------------------------------------------------------------------

def whole_grads(opt) -> Dict[str, "torch.Tensor"]:
    """name → fp32 gradient of every parameter of the whole model, on the
    rank's device (FSDP: the shards' mean gradients gathered over the data
    ranks; then the model ranks' shards and the stages'; every rank takes
    part)."""
    import torch
    from ..parallel import collectives as C
    layout = opt.layout
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in layout.params]
    if layout.fsdp:
        split = [i for i, d in enumerate(layout.dims) if d is not None]
        whole = C.all_gather_shards([layout.shards[i].grad for i in split],
                                    [layout.dims[i] for i in split],
                                    layout.mesh.group("data"))
        for i, w in zip(split, whole):
            grads[i] = w
    out = layout.whole_tensors([[g] for g in grads])
    return {n: t[0].detach().float() for n, t in zip(layout.whole, out)}


def whole_params(opt) -> Dict[str, "torch.Tensor"]:
    """name → fp32 copy of every parameter of the whole model, on the
    rank's device."""
    layout = opt.layout
    params = layout.full_params()
    out = layout.whole_tensors([[params[n]] for n in layout.names])
    return {n: t[0].detach().float().clone()
            for n, t in zip(layout.whole, out)}


def first_update_off_share(run: dict, ref: dict, initial,
                           device=None) -> float:
    """The share of the first update's elements (over every tensor that
    moved in the oracle) more than :data:`OFF_SHARE_OF_MAX` of their
    tensor's largest oracle update away from the oracle's."""
    import torch
    off = total = 0
    for n, want in ref["first_params"].items():
        init = initial[n].to(device, torch.float64)
        upd = want.to(device, torch.float64) - init
        if not upd.any():
            continue
        got = run["first_params"][n].to(device, torch.float64) - init
        off += int(((got - upd).abs()
                    > OFF_SHARE_OF_MAX * upd.abs().max()).sum())
        total += upd.numel()
    return off / total


def compare(run: dict, ref: dict, initial, device=None) -> dict:
    """``data_parallel_check.compare`` and the largest per-tensor
    relative error of the first step's gradients, ``max_grad_rel`` (a
    gradient counted twice keeps its cosine); the first step's loss and
    norm relative differences and :func:`first_update_off_share`."""
    import torch
    out = dpc.compare(run, ref, initial, device)
    first, want = run["metrics"][0], ref["metrics"][0]
    out.update(
        first_loss_rel=abs(first["total_loss"] - want["total_loss"])
        / abs(want["total_loss"]),
        first_grad_norm_rel=abs(first["grad_norm"] - want["grad_norm"])
        / want["grad_norm"],
        first_update_off_share=first_update_off_share(run, ref, initial,
                                                      device))
    rel = {}
    for n, want in ref["grads"].items():
        if n.endswith("self_attn.k_proj.bias") or not want.any():
            continue
        w = want.to(device, torch.float64)
        rel[n] = ((run["grads"][n].to(device, torch.float64) - w).norm()
                  / w.norm()).item()
    worst = max(rel, key=rel.get)
    out.update(max_grad_rel=rel[worst], max_grad_rel_tensor=worst)
    return out


def replay_first_update(tcfg, initial, anchors, grads, first,
                        device) -> float:
    """The largest per-tensor relative difference between the run's first
    update (``first`` − ``initial``) and one process's optimizer
    (``tcfg``'s, no clipping: ``grads`` are those the run's optimizer
    stepped, already clipped) stepping ``grads`` from ``initial`` with
    ``anchors``."""
    import dataclasses
    import torch
    from ..optim.factory import make_optimizer
    params = {n: t.to(device).clone().requires_grad_()
              for n, t in initial.items()}
    opt = make_optimizer(dataclasses.replace(tcfg, max_grad_norm=0.0),
                         params.items(), anchors=anchors)
    for n, p in params.items():
        p.grad = grads[n].to(device)
    opt.step()
    worst = 0.0
    with torch.no_grad():
        for n, p in params.items():
            want = (p.double() - initial[n].to(device).double())
            if want.any():
                got = first[n].to(device).double() \
                    - initial[n].to(device).double()
                worst = max(worst, ((got - want).norm()
                                    / want.norm()).item())
    return worst


def oracle_config(B: int, accum: int, dtype: str, quant: str = "none"):
    """The one-process oracle's config: global negatives, ``quant``."""
    import dataclasses
    return dataclasses.replace(dpc.train_config("global", B, accum, dtype),
                               quant=quant)


def prepare(model_name: str, layers: Optional[int], dtype: str, B: int,
            accum: int, seed: int, steps: int, device=None,
            path: Optional[str] = None, quant: str = "none") -> dict:
    """The weights, AdamSPD's anchors and the one-process oracle of
    :func:`rank_modes` for the modes of ``quant`` (the oracle's tensors on
    ``device``); with ``path`` also written there (CPU tensors) for ranks
    to load in place of computing them again."""
    import torch
    from ..models.convert import random_params, state_dict_from_jax
    cfg = dpc.model_config(model_name, layers)
    sd = state_dict_from_jax(random_params(cfg, seed), cfg)
    anchors = dpc.anchors_off(sd, seed)
    ref = dpc.oracle(cfg, oracle_config(B, accum, dtype, quant), sd,
                     {k: v.to(device) for k, v in anchors.items()},
                     dpc.global_batch(cfg, accum, B, seed), steps, 1, device)
    out = {"sd": sd, "anchors": anchors, "ref": ref, "quant": quant}
    if path is not None:
        torch.save(out, path)
    return out


def rank_modes(model_name: str, layers: Optional[int], dtype: str, B: int,
               accum: int, seed: int, steps: int, modes: List[str],
               fault: Optional[str] = None,
               prepared: Optional[List[str]] = None) -> dict:
    """On every rank (the group is up, its size each mode's rank count):
    each mode's ``steps`` on this rank's rows of the global batch
    ``[accum, B, …]``; on rank 0 also the oracles (one a ``quant`` mode,
    :func:`quant_of`) and the comparisons. ``prepared``: files of
    :func:`prepare` for these arguments (one a ``quant`` mode), read in
    place of computing the weights, anchors and oracles. Returns per mode:
    metrics, first-step launches, step ms, peak memory, host seconds, and
    on rank 0 ``vs_oracle``."""
    import torch
    from ..models import clip as m
    from ..ops import _build
    from ..optim.factory import make_optimizer
    from ..parallel import mesh as pmesh
    from ..train.engine import make_train_step

    inject(fault)
    t_start = time.perf_counter()
    rank = torch.distributed.get_rank()
    device = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    cfg = dpc.model_config(model_name, layers)
    quants = sorted({quant_of(mode) for mode in modes})
    refs = {}
    if prepared is not None:
        for path in prepared:
            ready = torch.load(path, map_location="cpu", weights_only=True,
                               mmap=True)
            refs[ready.get("quant", "none")] = ready.pop("ref")
    else:
        from ..models.convert import random_params, state_dict_from_jax
        sd = state_dict_from_jax(random_params(cfg, seed), cfg)
        ready = {"sd": sd, "anchors": dpc.anchors_off(sd, seed)}
        if rank == 0:
            for quant in quants:
                refs[quant] = prepare(model_name, layers, dtype, B, accum,
                                      seed, steps, device,
                                      quant=quant)["ref"]
    sd = ready["sd"]
    anchors = {k: v.to(device) for k, v in ready["anchors"].items()}
    batch = dpc.global_batch(cfg, accum, B, seed)
    initial = None
    if rank == 0:   # the comparisons run on the device
        refs = {q: {k: v if k == "metrics" else {n: t.to(device)
                                                 for n, t in v.items()}
                    for k, v in refs[q].items()} for q in quants}
        initial = {k: v.to(device, torch.float32) for k, v in sd.items()}
    setup_s = time.perf_counter() - t_start
    out = {}
    for mode in modes:
        t_mode = time.perf_counter()
        tcfg = train_config(mode, B, accum, dtype)
        mesh = pmesh.make_mesh(tcfg.mesh, device,
                               sequence_parallel=tcfg.sequence_parallel,
                               sp_ring=tcfg.sp_ring)
        local = {k: torch.from_numpy(x.copy()).to(device)
                 for k, x in pmesh.shard_batch(batch, mesh,
                                               accum_axis=True).items()}
        model = m.build_train_model(cfg, sd, device=device, mesh=mesh,
                                    num_micro=tcfg.pipeline_microbatches,
                                    global_negatives=tcfg.global_negatives)
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
                grads = whole_grads(opt)
                first = whole_params(opt)
            metrics.append({k: float(v) for k, v in got.items()})
        run = {"metrics": metrics, "grads": grads, "first_params": first,
               "params": whole_params(opt)}
        res = {"metrics": metrics, "launches": launches,
               "step_ms": ms[1:] if len(ms) > 1 else ms,
               "peak_memory_gb": torch.cuda.max_memory_allocated(device)
               / 1e9 if device.type == "cuda" else None,
               "mesh": dict(mode_spec(mode)[0]), "rank": rank}
        t_cmp = time.perf_counter()
        if rank == 0:
            res["vs_oracle"] = compare(run, refs[quant_of(mode)], initial,
                                       device)
            res["vs_oracle"]["replay_first_update_rel"] = \
                replay_first_update(oracle_config(B, accum, dtype),
                                    initial, anchors, grads, first, device)
        del model, opt, step, run
        if device.type == "cuda":
            torch.cuda.empty_cache()
        now = time.perf_counter()
        # Host seconds: setup (weights, batch) and rank 0's oracle, before
        # the first mode; each mode's whole time and its comparisons.
        res["seconds"] = {"setup": setup_s, "mode": now - t_mode,
                          "compare": now - t_cmp}
        if mode == modes[0]:
            res["seconds"]["before_first_mode"] = t_mode - t_start
        out[mode] = res
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="ViT-B/16")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--batch", type=int, default=32, help="global rows")
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--modes", nargs="*", default=list(MODES))
    ap.add_argument("--fault", default=None, choices=sorted(all_faults()))
    args = ap.parse_args(argv)
    from ..parallel.launch import spawn
    env = {"LOCAL_RANK": "0"} if args.device == "cuda" else {}
    by_world: Dict[int, List[str]] = {}
    for mode in args.modes:
        by_world.setdefault(ranks_of(mode), []).append(mode)
    for world, modes in sorted(by_world.items()):
        ranks = spawn(rank_modes, world,
                      (args.model, args.layers, args.dtype, args.batch,
                       args.accum, args.seed, args.steps, modes, args.fault),
                      timeout_s=3000, device=args.device, backend="gloo",
                      env=env)
        for mode, res in ranks[0].items():
            vs = {k: v for k, v in res["vs_oracle"].items()
                  if k not in ("losses", "oracle_losses", "grad_norms",
                               "oracle_grad_norms")}
            print(json.dumps({"mode": mode, "layers": args.layers,
                              "dtype": args.dtype, "fault": args.fault,
                              **vs, "step_ms": res["step_ms"]}))
            same = all(r[mode]["metrics"] == res["metrics"] for r in ranks)
            print(json.dumps({"mode": mode, "ranks_agree": same}))
            if not all(math.isfinite(x["total_loss"])
                       for x in res["metrics"]):
                raise SystemExit(f"{mode}: a loss is not finite")


if __name__ == "__main__":
    main()
