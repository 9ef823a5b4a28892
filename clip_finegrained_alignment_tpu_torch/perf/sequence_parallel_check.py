"""Sequence parallelism held to one process, and what it costs at the size
it is for.

**The modes** (``chip_smoke.py`` phase 11), run by
``model_parallel_check.rank_modes`` like the tensor- and pipeline-parallel
ones: W gloo ranks laid out as ``data × model`` (the model axis the
sequence axis, ``parallel/sequence.py``) each step SPARC + AdamSPD with
global negatives on their data coordinate's rows of one global batch,
and rank 0 holds every mode to the one-process oracle
(``data_parallel_check.oracle``), with the same comparisons:

* ``sp2``: 1 x 2, GSPMD SP (each rank's queries against K and V gathered
  over the two ranks);
* ``sp2-ring``: 1 x 2, ring attention;
* ``dp2sp2-ring``: 2 x 2, ring attention, FSDP over the data ranks;
* ``sp2-int8``: ``sp2`` with ``quant="int8"``, its int8 wgrad's scales
  over both ranks' token blocks, held to a one-process ``int8`` oracle.

:data:`FAULTS` are the faults the gates are for (``parallel/sequence.py``,
the gradient rule): ``gather_sums_cotangent`` lets a tower's gather sum
the model ranks' (equal) cotangents in its backward, so every gradient
before the gather comes out n times its part; ``post_gather_summed`` sums
the gradients of the parameters after the gather over the model ranks
too (they are whole already); and ``model_parallel_check``'s
``norm_counts_tp``, the norm counting every copy on every model rank.

**The memory reading** (``--memory``): at ViT-L/14@336 (577 vision
tokens, the configuration sequence parallelism is for), one microbatch of
B rows forward and backward (SPARC, bf16 by default, no optimizer step),
in one process on the card and on two ``sp2-ring`` ranks sharing it: each
one's milliseconds, peak memory and loss, and the ranks' loss against
the one process's. The one process runs the fused attention kernels (#1
and #2); the ranks run the ring's fp32 scores in PyTorch, so the reading
shows what the ring's memory saving is worth against a kernel that never
holds the scores::

    python -m clip_finegrained_alignment_tpu_torch.perf.sequence_parallel_check \\
        --memory --model ViT-L/14@336 --batch 8

On the CPU, at fewer layers, the modes are the study that set phase 11's
``SP_LIMITS``::

    python -m clip_finegrained_alignment_tpu_torch.perf.sequence_parallel_check \\
        --device cpu --layers 2 [--fault NAME]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from . import data_parallel_check as dpc
from ._measure import synchronize

MODES = {"sp2": ({"data": 1, "model": 2, "pipe": 1},
                 {"sequence_parallel": True}),
         "sp2-ring": ({"data": 1, "model": 2, "pipe": 1},
                      {"sequence_parallel": True, "sp_ring": True}),
         "dp2sp2-ring": ({"data": 2, "model": 2, "pipe": 1},
                         {"sequence_parallel": True, "sp_ring": True,
                          "fsdp": True}),
         "sp2-int8": ({"data": 1, "model": 2, "pipe": 1},
                      {"sequence_parallel": True, "quant": "int8"})}


# ---------------------------------------------------------------------------
# The faults
# ---------------------------------------------------------------------------

def _gather_sums_cotangent():
    from ..parallel import collectives as C
    from ..parallel import sequence

    def gather_tokens(x, S, seq):
        # The ranks' cotangents summed in the backward.
        y = C.all_gather_with_grad(x.transpose(0, 1).contiguous(),
                                   seq.mesh.group("model"))
        return y.transpose(0, 1)[:, :S]
    sequence.gather_tokens = gather_tokens


def _post_gather_summed():
    from ..train import engine
    engine.before_gather = lambda name: True


def _norm_counts_tp():
    from . import model_parallel_check as mpc
    mpc.FAULTS["norm_counts_tp"]()


def _quant_shard_scales():
    from . import model_parallel_check as mpc
    mpc.FAULTS["quant_shard_scales"]()


FAULTS = {"gather_sums_cotangent": _gather_sums_cotangent,
          "post_gather_summed": _post_gather_summed,
          "norm_counts_tp": _norm_counts_tp,
          "quant_shard_scales": _quant_shard_scales}


# ---------------------------------------------------------------------------
# The memory reading
# ---------------------------------------------------------------------------

def memory_rank(model_name: str, layers: Optional[int], dtype: str, B: int,
                seed: int, reps: int, ring: bool = True) -> dict:
    """One microbatch of ``B`` rows, forward and backward, ``reps`` times
    after one untimed: in this process alone, or on every rank of the
    group as one sequence group (``ring``: ring attention). Returns the
    loss, the timed ms, the peak memory after the first run (GB) and the
    port's kernel launches of one run."""
    import torch
    import torch.distributed as dist
    from ..config import MeshConfig, TrainConfig
    from ..models import clip as m
    from ..models.convert import random_params, state_dict_from_jax
    from ..ops import _build
    from ..parallel import mesh as pmesh
    from ..parallel.sequence import SeqParallelSpec
    from ..train.engine import compute_loss

    world = dist.get_world_size() if dist.is_initialized() else 1
    device = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    cfg = dpc.model_config(model_name, layers)
    tcfg = TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                       batch_size=B, inverse_temperature=0.07,
                       use_amp=dtype == "bfloat16", global_negatives=True,
                       sequence_parallel=world > 1, sp_ring=ring,
                       mesh=MeshConfig(data=1, model=world))
    mesh = seq = None
    if world > 1:
        mesh = pmesh.make_mesh(tcfg.mesh, device, sequence_parallel=True,
                               sp_ring=ring)
        seq = SeqParallelSpec(mesh, ring=ring)
    sd = state_dict_from_jax(random_params(cfg, seed), cfg)
    model = m.build_train_model(cfg, sd, device=device, mesh=mesh)
    del sd
    batch = {k: torch.from_numpy(x[0].copy()).to(device)
             for k, x in dpc.global_batch(cfg, 1, B, seed).items()}
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ms, loss, launches = [], None, None
    for r in range(reps + 1):
        synchronize(device)
        if r == 0:
            _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = compute_loss(model, batch, tcfg, cfg, dtype=dt, mesh=mesh,
                               seq=seq)
        loss.backward()
        synchronize(device)
        if r == 0:
            launches = _build.launch_counts()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
        else:
            ms.append((time.perf_counter() - t0) * 1e3)
        model.zero_grad(set_to_none=True)
    return {"world": world, "ring": ring and world > 1,
            "loss": loss.item(), "ms": ms,
            "launches": launches,
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None}


def memory_reading(model_name: str, layers: Optional[int], dtype: str,
                   B: int, seed: int, reps: int, device: str) -> dict:
    """:func:`memory_rank` in this process, then on two ``sp2-ring``
    ranks sharing the card (gloo), and the ranks' loss against the one
    process's."""
    import torch
    from ..parallel.launch import spawn
    one = memory_rank(model_name, layers, dtype, B, seed, reps)
    if device == "cuda":
        torch.cuda.empty_cache()
    env = {"LOCAL_RANK": "0"} if device == "cuda" else {}
    ranks = spawn(memory_rank, 2, (model_name, layers, dtype, B, seed, reps),
                  timeout_s=1200, device=device, backend="gloo", env=env)
    return {"model": model_name, "layers": layers, "dtype": dtype, "B": B,
            "one_process": one, "sp2_ring": ranks,
            "loss_rel": abs(ranks[0]["loss"] - one["loss"])
            / abs(one["loss"])}


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
    ap.add_argument("--fault", default=None, choices=sorted(FAULTS))
    ap.add_argument("--memory", action="store_true",
                    help="the memory reading (one microbatch of --batch "
                         "rows, --steps timed runs) in place of the modes")
    args = ap.parse_args(argv)
    if args.memory:
        out = memory_reading(args.model, args.layers, args.dtype,
                             args.batch, args.seed, args.steps, args.device)
        print(json.dumps(out))
        if args.device == "cuda":
            import chip_smoke
            print(chip_smoke.gpu_line())
        return
    from . import model_parallel_check as mpc
    mpc.main(["--device", args.device, "--model", args.model, "--dtype",
              args.dtype, "--batch", str(args.batch), "--accum",
              str(args.accum), "--steps", str(args.steps), "--seed",
              str(args.seed), "--modes", *args.modes]
             + (["--layers", str(args.layers)] if args.layers else [])
             + (["--fault", args.fault] if args.fault else []))


if __name__ == "__main__":
    main()
