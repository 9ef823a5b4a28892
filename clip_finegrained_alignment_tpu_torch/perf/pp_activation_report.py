"""GPipe's peak memory a stage, the port of ``perf/pp_activation_report.py``.

Two ranks, one pipeline of two stages (``parallel/pipeline.py``: each
holds half of both towers' layers; the embeddings, heads and loss are
whole on both), step SPARC + AdamSPD with global negatives on random
weights (``models/convert.py::random_params``) and a random global batch
(``perf/data_parallel_check.py::global_batch``), one train microbatch of
B rows split into M GPipe microbatches. Each rank reads its own peak:
one warm-up step (the optimizer's state is made there), then
``torch.cuda.reset_peak_memory_stats``, one step, and
``torch.cuda.max_memory_allocated``, beside the memory held before the
step (weights, optimizer state, the last step's gradients). Swept:

* M at a fixed global batch B (GPipe keeps every microbatch's stage
  inputs until the backward; at a fixed B their total does not depend
  on M);
* B at a fixed pipeline microbatch b = B / M (the honest linear term);

and the unpipelined step at the same B in one process (rank 0, while
rank 1 waits), whose peak each stage should undercut. Every row's loss is
printed beside it: at one B the pipelined steps compute the unpipelined
step's loss.

On the card the two ranks are gloo processes sharing ``cuda:0``, as in
``chip_smoke.py`` phase 11 (each process's allocator counts its own
tensors only)::

    python -m clip_finegrained_alignment_tpu_torch.perf.pp_activation_report

Defaults: ViT-B/16 whole, bf16, M ∈ {2, 4, 8} at B = 32, B ∈ {8, 16,
32} at b = 4, the unpipelined step at B = 32. One line a row, then one
JSON object of them all, with ``device`` and ``gpu`` (the card's name and
power limit). ``--device cpu`` (with ``--model tiny``) is for the tests:
memory is not measured there (null).

JAX's report also sweeps rematerialization (off, dots, full) inside the
stages; the port never rematerializes (``ROADMAP.md``, "Not to port"), so
that sweep has no counterpart. Like JAX's, it has no 1F1B schedule to
compare: every loss here is contrastive over the whole batch, so no
microbatch's backward can start before the last microbatch's forward.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

from . import data_parallel_check as dpc
from ..models.clip import resolve_device
from ._measure import device_fields, synchronize

MICRO_SWEEP = (2, 4, 8)             # M at B = FIXED_B
FIXED_B = 32
BATCH_SWEEP = ((8, 2), (16, 4), (32, 8))    # (B, M) at b = 4


def _config(B: int, M: int, dtype: str, pipe: int):
    from ..config import MeshConfig, TrainConfig
    return TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                       inverse_temperature=0.07, batch_size=B,
                       gradient_accumulation_steps=1,
                       use_amp=dtype == "bfloat16", global_negatives=True,
                       pipeline_microbatches=M,
                       mesh=MeshConfig(data=1, model=1, pipe=pipe))


def _peak_step(cfg, tcfg, sd, batch, device, mesh=None) -> dict:
    """One warm-up step and one read step: the read step's peak, the
    memory held before it (GB; null on the CPU) and its loss."""
    import torch

    from ..models import clip as m
    from ..optim.factory import make_optimizer
    from ..train.engine import make_train_step
    model = m.build_train_model(cfg, sd, device=device, mesh=mesh,
                                num_micro=tcfg.pipeline_microbatches,
                                global_negatives=True)
    opt = make_optimizer(tcfg, model.named_parameters(), mesh=mesh)
    step = make_train_step(tcfg, cfg, model, opt, mesh=mesh)
    step(batch)
    synchronize(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device) / 1e9 if on_card else None
    loss = step(batch)["total_loss"].item()
    synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None
    del model, opt, step
    if on_card:
        torch.cuda.empty_cache()
    return {"peak_memory_gb": peak, "held_before_step_gb": held,
            "step_gb": None if peak is None else peak - held, "loss": loss}


def rank_report(device_type: str, model_name: str, layers: Optional[int],
                dtype: str, fixed_B: int, micro_sweep: Sequence[int],
                batch_sweep: Sequence[Tuple[int, int]],
                seed: int = 0) -> List[dict]:
    """On each of the group's two ranks (a pipe of two stages) on
    ``device_type`` (``cuda``: the rank's current card): a row per swept
    (B, M), then, on rank 0 only, the unpipelined step at ``fixed_B``."""
    import torch
    import torch.distributed as dist

    from ..models.convert import random_params, state_dict_from_jax
    from ..parallel import mesh as pmesh

    rank = dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    cfg = dpc.model_config(model_name, layers)
    sd = state_dict_from_jax(random_params(cfg, seed), cfg)
    mesh = pmesh.make_mesh(_config(fixed_B, 2, dtype, 2).mesh, device)
    runs = ([("M sweep", fixed_B, M) for M in micro_sweep]
            + [(f"B sweep @ b={B // M}", B, M) for B, M in batch_sweep])
    rows = []
    for label, B, M in runs:
        batch = {k: torch.from_numpy(x).to(device)
                 for k, x in dpc.global_batch(cfg, 1, B, seed).items()}
        rows.append({"label": label, "B": B, "M": M, "rank": rank,
                     "stage": mesh.pipe_rank,
                     **_peak_step(cfg, _config(B, M, dtype, 2), sd, batch,
                                  device, mesh)})
    if rank == 0:
        batch = {k: torch.from_numpy(x).to(device)
                 for k, x in dpc.global_batch(cfg, 1, fixed_B, seed).items()}
        rows.append({"label": "unpipelined", "B": fixed_B, "M": None,
                     "rank": 0, "stage": None,
                     **_peak_step(cfg, _config(fixed_B, 0, dtype, 1), sd,
                                  batch, device)})
    dist.barrier()
    return rows


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ViT-B/16")
    ap.add_argument("--layers", type=int, default=None,
                    help="both towers cut to this many layers (even)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..parallel.launch import spawn

    device = resolve_device(args.device)
    env = {"LOCAL_RANK": "0"} if device.type == "cuda" else {}
    ranks = spawn(rank_report, 2,
                  (device.type, args.model, args.layers, args.dtype, FIXED_B,
                   MICRO_SWEEP, BATCH_SWEEP), timeout_s=1800,
                  device=device.type,
                  backend="gloo", env=env)
    rows = sorted((r for rank in ranks for r in rank),
                  key=lambda r: (r["label"], r["B"], r["M"] or 0, r["rank"]))
    for r in rows:
        print(f"{r['label']:<18} B={r['B']:>3} M={r['M'] or '-':>2} "
              f"rank {r['rank']}: peak "
              + ("not measured" if r["peak_memory_gb"] is None else
                 f"{r['peak_memory_gb']:.3f} GB (held "
                 f"{r['held_before_step_gb']:.3f}, step "
                 f"{r['step_gb']:.3f})")
              + f", loss {r['loss']:.6f}", flush=True)
    out = {"model": args.model, "layers": args.layers, "dtype": args.dtype,
           "rows": rows, **device_fields(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
