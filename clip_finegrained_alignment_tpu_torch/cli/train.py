"""Training CLI, the port of ``clip_finegrained_alignment_tpu/cli/train.py``
on one card or data-parallel over several: the loss and optimizer flags
pick the behaviour, the data flags the ingest (live decode of an
annotations file, or a packed dataset with its pixels kept on the
device).

Example::

    python -m clip_finegrained_alignment_tpu_torch.cli.train \\
        --packed data/synthetic_packed --device-data --model ViT-B/16 \\
        --loss-type sparc --optimizer adamspd --epochs 10 \\
        --experiment-name sparc_spd_b16

It runs on the card unless ``--device cpu`` is given; with no card it
fails, it does not fall back. ``--resume`` restores ``best/`` (or the
checkpoint directory given) step-exact: the interrupted epoch's completed
steps are skipped, not trained again. ``--grad-cache`` (clip and sparc)
trains one loss over the whole batch-size x grad-accum pool
(``train/gradcache.py``). ``--pretrained x.pt --import-optimizer-state``
goes on from a reference training checkpoint mid-run: its
``optimizer_state_dict`` (AdamSPD or AdamW, ``optim/interop.py``) is
restored with the weights, and the step and best loss come from its
metadata. ``--quant switchback|int8`` runs the encoder projections and
the patch embedding as dynamic int8 GEMMs (``ops/quant.py``: the
hand-written quantize and dequantize kernels around ``torch._int_mm``).

Several GPUs, one process each (``parallel/``)::

    torchrun --nproc_per_node 8 -m \
        clip_finegrained_alignment_tpu_torch.cli.train --packed DIR \
        --device-data --model ViT-B/16 --batch-size 256 \
        --global-negatives --zero1

``--batch-size`` is global and must divide by the world size; each rank
reads its own contiguous shard of every epoch's permutation at
``batch-size x grad-accum / W`` a step (so a W-rank run's batch b is not a
one-process run's batch b). Without ``--global-negatives`` each rank's
loss sees its own rows and the gradients are averaged (the reference's
DDP); with it the contrastive terms see the global batch. ``--zero1``
shards the optimizer state, ``--fsdp`` (with ``--global-negatives``) the
parameters too. Rank 0 prints, logs and writes the checkpoints (whole
tensors, which resume at any layout and rank count).

Tensor and pipeline parallelism (with ``--global-negatives``, as in
JAX)::

    torchrun --nproc_per_node 8 -m \
        clip_finegrained_alignment_tpu_torch.cli.train --packed DIR \
        --device-data --model ViT-B/16 --batch-size 256 \
        --global-negatives --model-parallel 2 --pipeline-parallel 2 \
        --pipeline-microbatches 4

lays the W ranks out as ``data × model × pipe`` with data = W / (model ·
pipe) (``parallel/mesh.py``): ``--model-parallel`` splits every encoder
layer Megatron-style, ``--pipeline-parallel`` cuts both towers' layers
into GPipe stages, each train microbatch split into
``--pipeline-microbatches`` (default 2 x the stages). ``--batch-size``
must divide by the data degree; ranks that share a data coordinate read
the same shard. ``--zero1`` and ``--fsdp`` compose with both, and so
does ``--quant``, with the scales JAX's GSPMD step takes (``ops/quant.py``:
a split contraction's absmax over the model ranks; the int8 wgrad's over
the data ranks under ``--global-negatives``).

Sequence parallelism (with ``--global-negatives``; not with
``--model-parallel`` or ``--pipeline-parallel``, as in JAX)::

    torchrun --nproc_per_node 8 -m \
        clip_finegrained_alignment_tpu_torch.cli.train --packed DIR \
        --device-data --model ViT-L/14@336 --batch-size 64 \
        --global-negatives --sequence-parallel 2 --sp-ring --fsdp

splits the encoders' tokens over ``--sequence-parallel`` ranks (the mesh's
model axis; data = W / N): attention reaches every key through K and V
gathered over the ranks, or with ``--sp-ring`` through ring attention
(``parallel/sequence.py``). The parameters stay whole on every rank;
``--zero1`` and ``--fsdp`` shard over the data ranks.

Left out, against the JAX CLI: the TPU knobs (``--pallas``,
``--fused-sparc``, ``--remat``, ``--unroll-*``, ``--unstack-layers``).
``--eval-every-epoch`` (count loss only) holds out the first batch of
epoch 0 and runs ``eval/batch_eval.py::evaluate_batch`` on it in fp32 on
the trainer's master weights (under ``--model-parallel``,
``--pipeline-parallel`` or ``--fsdp`` gathered whole, then evaluated by
rank 0; whole on every rank under ``--sequence-parallel``), before
training (when the run starts at
epoch 0) and after every epoch, between the epochs' timings; it logs
``count_eval_accuracy`` and writes ``confusion_{pretrain|epoch_<n>}.png``
into the checkpoint directory. ``--pretrained`` takes a local
reference checkpoint only (``.pt``, ``.pth``, ``.bin``; HF or OpenAI
names): HF downloads are out of reach. Deliberate
differences: with no ``--pretrained`` the weights are
``models/convert.py::random_params(cfg, seed)`` (numpy), checkpoints are
torch files, and ``--profile-dir`` writes a ``torch.profiler`` trace.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import warnings
from typing import Any, Dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--annotations", default=None,
                   help="synthetic_annotations.json path (live decode)")
    p.add_argument("--packed", default=None, metavar="DIR",
                   help="packed dataset directory (cli.pack_dataset) "
                        "instead of --annotations: one copy a batch "
                        "instead of a decode a sample")
    p.add_argument("--device-data", action="store_true",
                   help="with --packed: place the whole uint8 pixel array "
                        "on the device once and gather batches by index "
                        "there (4 bytes a sample a step over PCIe)")
    p.add_argument("--model", default="ViT-B/32",
                   help="ViT-B/32 | ViT-B/16 | ViT-L/14 | tiny")
    p.add_argument("--loss-type", default="sparc",
                   choices=["clip", "sparc", "count", "clip_count"])
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adamspd"])
    p.add_argument("--amsgrad", action="store_true",
                   help="amsgrad moment maxima for AdamSPD")
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--count-alpha", type=float, default=1.0)
    p.add_argument("--inverse-temperature", type=float, default=0.07)
    p.add_argument("--similarity-threshold", type=float, default=0.5)
    p.add_argument("--experiment-name", default="clip_finetune")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", nargs="?", const=True, default=False,
                   metavar="CKPT_DIR",
                   help="resume from <checkpoint-dir>/<experiment>/best if "
                        "present, or from the checkpoint directory given "
                        "(e.g. .../preempt)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save-every", type=int, default=5)
    p.add_argument("--log-every", type=int, default=10,
                   help="print a loss line every N optimizer steps")
    p.add_argument("--no-amp", action="store_true",
                   help="full fp32 (use_amp=False)")
    p.add_argument("--pretrained", default=None,
                   help="a local reference checkpoint (.pt, .pth or .bin; "
                        "HF or OpenAI names) to start from (default: "
                        "random weights from --seed)")
    p.add_argument("--import-optimizer-state", action="store_true",
                   help="with --pretrained <reference .pt>: also restore "
                        "its optimizer_state_dict (AdamSPD moments, step "
                        "and anchors, or the two-group AdamW state), its "
                        "global_step and best_loss: a mid-run migration")
    p.add_argument("--grad-cache", action="store_true",
                   help="GradCache: one contrastive loss over the whole "
                        "batch-size x grad-accum pool at one chunk's "
                        "activation memory (embed, loss on the cache, "
                        "re-forward and backward each chunk; "
                        "train/gradcache.py). clip and sparc only")
    p.add_argument("--quant", default="none",
                   choices=["none", "switchback", "int8"],
                   help="dynamic-int8 tensor-core path for the encoder "
                        "projection GEMMs and the patch embedding "
                        "(ops/quant.py). switchback = int8 fwd+dgrad, "
                        "exact wgrad (arXiv:2304.13013); int8 = all three "
                        "matmuls. Bounded numerics change — not a parity "
                        "mode")
    p.add_argument("--global-negatives", action="store_true",
                   help="contrastive loss over the global batch (a "
                        "gradient-carrying all-gather of the embeddings) "
                        "instead of DDP-parity local negatives")
    p.add_argument("--zero1", action="store_true",
                   help="shard the optimizer state (AdamSPD moments and "
                        "anchors) over the data ranks, ZeRO-1 style")
    p.add_argument("--fsdp", action="store_true",
                   help="shard the parameters too (FSDP): gathered for "
                        "each step, gradients reduce-scattered. Subsumes "
                        "--zero1; requires --global-negatives")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel degree (Megatron column/row "
                        "splits of every encoder layer); requires "
                        "--global-negatives")
    p.add_argument("--pipeline-parallel", type=int, default=1,
                   help="pipeline stages (GPipe over both towers' "
                        "encoder layers); requires --global-negatives")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="GPipe microbatches a train microbatch (0 = 2 x "
                        "the stages)")
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="sequence-parallel degree: the encoders' tokens "
                        "split over this many ranks (the mesh's model "
                        "axis), the parameters whole on each; requires "
                        "--global-negatives, excludes --model-parallel "
                        "and --pipeline-parallel")
    p.add_argument("--sp-ring", action="store_true",
                   help="with --sequence-parallel: ring attention (K and "
                        "V blocks passed around the ranks under an online "
                        "softmax) in place of gathering K and V")
    p.add_argument("--bpe-path", default=None,
                   help="CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz or "
                        "an HF tokenizer dir). Required unless "
                        "$CLIP_BPE_PATH is set or "
                        "CFA_ALLOW_HASH_TOKENIZER=1 opts into the "
                        "hermetic hash tokenizer")
    p.add_argument("--eval-every-epoch", action="store_true",
                   help="with --loss-type count: the counting batch-eval "
                        "of a held-out batch before training and after "
                        "every epoch")
    p.add_argument("--metrics-file", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 2-4 into "
                        "this directory")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def _refuse(args) -> None:
    """Exit non-zero on flags that cannot be honoured, naming why."""
    if args.import_optimizer_state and not args.pretrained:
        raise SystemExit("--import-optimizer-state requires --pretrained "
                         "<reference .pt checkpoint>")
    if args.import_optimizer_state and args.resume:
        raise SystemExit("--resume and --import-optimizer-state both "
                         "restore optimizer state: pick one source")
    if args.pretrained and not args.pretrained.endswith(
            (".pt", ".pth", ".bin")):
        raise SystemExit(f"--pretrained {args.pretrained!r}: only a local "
                         "reference .pt checkpoint is accepted; HF "
                         "downloads are out of reach (no network)")
    if bool(args.packed) == bool(args.annotations):
        raise SystemExit("pass exactly one of --annotations / --packed")
    if args.device_data and not args.packed:
        raise SystemExit("--device-data requires --packed")


def check_optimizer_import(ref_meta, cfg, path) -> dict:
    """The reference ``optimizer_state_dict`` that ``--import-optimizer-
    state`` restores, checked against this run: exit if it is missing or
    its amsgrad differs (the maxima would be dropped or made up); warn on
    each hyperparameter that differs from this run's flags, which are
    kept."""
    opt_sd = ref_meta.get("optimizer_state_dict")
    if opt_sd is None:
        raise SystemExit(f"{path} carries no optimizer_state_dict")
    g0 = opt_sd["param_groups"][0]
    for key, ours in (("lr", cfg.lr), ("betas", tuple(cfg.betas)),
                      ("eps", cfg.eps), ("weight_decay", cfg.weight_decay)):
        theirs = g0.get(key)
        theirs = tuple(theirs) if isinstance(theirs, (list, tuple)) \
            else theirs
        if theirs is not None and theirs != ours:
            warnings.warn(
                f"optimizer hyperparameter drift on import: checkpoint "
                f"{key}={theirs!r}, this run uses {ours!r}; pass the "
                "matching flag for an exact reference continuation")
    if bool(g0.get("amsgrad", False)) != cfg.amsgrad:
        raise SystemExit(
            f"checkpoint amsgrad={g0.get('amsgrad')} but this run has "
            f"amsgrad={cfg.amsgrad}: rerun with --amsgrad matching the "
            "checkpoint (importing across the mismatch would drop or make "
            "up the moment maxima)")
    if cfg.optimizer_type != "adamspd" and cfg.amsgrad:
        raise SystemExit("amsgrad AdamW has no counterpart here: only "
                         "AdamSPD imports amsgrad state")
    return opt_sd


def main(argv=None) -> Dict[str, Any]:
    """Run the CLI; returns what a caller in the same process may check:
    the ``trainer``, the ``pipeline``, the epoch ``history``, whether the
    run was ``preempted``, the ``image_path`` of live decode ("native" or
    "PIL"), the resume point and the card's peak memory."""
    args = build_parser().parse_args(argv)
    _refuse(args)

    import torch

    from ..config import MeshConfig, TrainConfig
    from ..data.datasets import (CounterfactualCaptionDataset,
                                 CountingDataPipeline,
                                 SyntheticCaptionDataset)
    from ..data.tokenizer import HashTokenizer, load_tokenizer
    from ..eval.batch_eval import evaluate_batch
    from ..models import clip as m
    from ..parallel import mesh as pmesh
    from ..train.checkpoint import CheckpointManager
    from ..train.engine import (Trainer, check_parallel,
                                install_preemption_handler)
    from ..utils.logging import MetricsLogger, ThroughputMeter, trace_capture

    device = pmesh.distributed_init(m.resolve_device(args.device))
    world = pmesh.world_size()
    writer = pmesh.rank() == 0
    say = print if writer else (lambda *a, **k: None)
    if args.sequence_parallel > 1 and (args.model_parallel > 1
                                       or args.pipeline_parallel > 1):
        raise SystemExit("--sequence-parallel cannot be combined with "
                         "--model-parallel or --pipeline-parallel (the "
                         "model axis is either the TP or the sequence "
                         "axis; train/engine.py)")
    degree = (args.model_parallel * args.pipeline_parallel
              * args.sequence_parallel)
    if degree > 1 and not args.global_negatives:
        raise SystemExit("--model-parallel/--pipeline-parallel/"
                         "--sequence-parallel > 1 require "
                         "--global-negatives: the DDP-parity shard_map path "
                         "assumes replicated params (train/engine.py)")
    if world % degree:
        raise SystemExit(f"--model-parallel {args.model_parallel} x "
                         f"--pipeline-parallel {args.pipeline_parallel} x "
                         f"--sequence-parallel {args.sequence_parallel} "
                         f"must divide the world size ({world} processes)")
    data = world // degree
    if args.batch_size % data:
        raise SystemExit(f"--batch-size {args.batch_size} must be divisible "
                         f"by the data-parallel degree ({data} of {world} "
                         "processes)")
    cfg = TrainConfig(
        lr=args.lr, batch_size=args.batch_size,
        gradient_accumulation_steps=args.grad_accum,
        max_epochs=args.epochs, weight_decay=args.weight_decay,
        use_amp=not args.no_amp, clip_model=args.model,
        experiment_name=args.experiment_name, loss_type=args.loss_type,
        similarity_threshold=args.similarity_threshold,
        inverse_temperature=args.inverse_temperature,
        optimizer_type=args.optimizer, amsgrad=args.amsgrad,
        count_alpha=args.count_alpha, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir, save_every=args.save_every,
        log_every=args.log_every, grad_cache=args.grad_cache,
        quant=args.quant, global_negatives=args.global_negatives,
        zero1=args.zero1, fsdp=args.fsdp,
        mesh=MeshConfig(data=data, model=max(args.model_parallel,
                                             args.sequence_parallel),
                        pipe=args.pipeline_parallel),
        pipeline_microbatches=args.pipeline_microbatches,
        sequence_parallel=args.sequence_parallel > 1, sp_ring=args.sp_ring)
    try:   # the layouts the step refuses exit here
        check_parallel(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    mesh = pmesh.make_mesh(cfg.mesh, device,
                           sequence_parallel=cfg.sequence_parallel,
                           sp_ring=cfg.sp_ring) if world > 1 else None
    shard = {} if mesh is None else {"process_index": mesh.data_rank,
                                     "process_count": mesh.data}
    if cfg.grad_cache:
        from ..train.gradcache import validate_gradcache
        try:
            validate_gradcache(cfg, mesh)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if writer:
        cfg.print_config()
    model_cfg = cfg.model_config()
    # Each rank's pipeline reads its data coordinate's shard at its share
    # of the batch.
    rank_batch = cfg.effective_batch_size // data

    # ---------------- data ----------------
    mode = "counterfactual" if args.loss_type == "count" else "standard"
    image_path = None
    if args.packed:
        from ..data.packed import PackedDataPipeline
        pipeline = PackedDataPipeline(
            args.packed, rank_batch, seed=cfg.seed,
            expect_mode=mode,
            expect_image_size=model_cfg.vision.image_size,
            expect_context_length=model_cfg.text.max_position_embeddings,
            index_only=args.device_data, **shard)
        say(f"packed dataset: {pipeline._num_samples()} samples, "
            f"{pipeline.steps_per_epoch()} steps/epoch"
            + (f", {pipeline.pixel_bank_bytes() / 1e9:.3f} GB pixel bank "
               f"on {device}" if args.device_data else ""))
    else:
        ds_cls = CounterfactualCaptionDataset if mode == "counterfactual" \
            else SyntheticCaptionDataset
        dataset = ds_cls(args.annotations)
        tokenizer = load_tokenizer(args.bpe_path)
        if isinstance(tokenizer, HashTokenizer) and \
                tokenizer.vocab_size != model_cfg.text.vocab_size:
            tokenizer = HashTokenizer(
                vocab_size=model_cfg.text.vocab_size,
                bos_token_id=model_cfg.text.bos_token_id,
                eos_token_id=model_cfg.text.eos_token_id,
                pad_token_id=model_cfg.text.pad_token_id)
        pipeline = CountingDataPipeline(
            dataset, rank_batch, mode=mode,
            image_size=model_cfg.vision.image_size,
            context_length=model_cfg.text.max_position_embeddings,
            tokenizer=tokenizer, seed=cfg.seed, **shard)
        image_path = "native" if pipeline._native else "PIL"
        say(f"dataset: {len(dataset)} samples, "
            f"{pipeline.steps_per_epoch()} steps/epoch, image decode: "
            f"{image_path}")

    # ---------------- weights ----------------
    state_dict = None
    if args.pretrained:
        from ..models.convert import load_reference_checkpoint
        state_dict, ref_meta = load_reference_checkpoint(args.pretrained,
                                                         model_cfg)
        say(f"loaded reference checkpoint (step "
            f"{ref_meta.get('global_step')})")
        if args.import_optimizer_state:
            opt_sd = check_optimizer_import(ref_meta, cfg, args.pretrained)

    # ---------------- engine ----------------
    ckpt_dir = os.path.join(args.checkpoint_dir, args.experiment_name)
    manager = CheckpointManager(ckpt_dir, save_every=cfg.save_every)
    trainer = Trainer(cfg, state_dict, device=device,
                      checkpoint_manager=manager,
                      pixel_bank=pipeline.pixel_bank()
                      if args.device_data else None, mesh=mesh)

    # Bare --resume = <ckpt-dir>/<exp>/best; --resume <path> = that
    # checkpoint directory (e.g. .../preempt).
    resume_dir, resume_which = None, None
    if isinstance(args.resume, str):
        path = os.path.abspath(args.resume.rstrip("/"))
        if not os.path.isdir(path):
            raise SystemExit(f"--resume {args.resume}: no such "
                             "checkpoint directory")
        resume_dir, resume_which = os.path.dirname(path), \
            os.path.basename(path)
    elif args.resume and os.path.isdir(os.path.join(ckpt_dir, "best")):
        resume_dir, resume_which = os.path.abspath(ckpt_dir), "best"

    start_epoch, resume_skip, resumed_at = 0, 0, None
    if args.import_optimizer_state:
        from ..optim.interop import load_reference_state
        step = load_reference_state(trainer.optimizer, opt_sd, model_cfg)
        trainer.global_step = int(ref_meta.get("global_step", step))
        trainer.best_loss = float(ref_meta.get("best_loss", float("inf")))
        start_epoch = trainer.global_step // max(
            1, pipeline.steps_per_epoch())
        say(f"imported reference optimizer state (step {step}"
            + (", SPD anchors restored" if cfg.optimizer_type == "adamspd"
               else "") + f"); global step {trainer.global_step}, "
            f"resuming at epoch {start_epoch}")
    if resume_which is not None:
        src = manager if resume_dir == manager.directory else \
            CheckpointManager(resume_dir, save_every=cfg.save_every)
        state, meta = src.restore(resume_which, config=cfg)
        trainer.load_state_dict(state)
        trainer.global_step = meta.get("global_step", 0)
        trainer.best_loss = meta.get("best_loss", float("inf"))
        resumed_at = trainer.global_step
        spe = max(1, pipeline.steps_per_epoch())
        start_epoch = trainer.global_step // spe
        # A mid-epoch (preempt) checkpoint resumes step-exact: the
        # deterministic pipeline replays the interrupted epoch and its
        # completed steps are skipped.
        resume_skip = trainer.global_step % spe
        say(f"resumed from {resume_dir}/{resume_which} at epoch "
            f"{start_epoch}"
            + (f" (skipping {resume_skip} completed steps)"
               if resume_skip else ""))

    metrics_log = MetricsLogger(args.metrics_file if writer else None)
    meter = ThroughputMeter()

    evaluating = args.eval_every_epoch and mode == "counterfactual"
    # Under tensor or pipeline parallelism or FSDP the model is in parts:
    # every rank gathers it whole (a collective) and rank 0 evaluates that
    # copy.
    in_parts = mesh is not None and (mesh.tensor_parallel or mesh.pipe > 1
                                     or cfg.fsdp)

    def count_eval(tag: str, step: int, what: str) -> None:
        model = trainer.model_state() if in_parts else trainer.model
        if eval_batch is None:
            return
        acc, _, _ = evaluate_batch(
            model, model_cfg, eval_batch, device=device, dtype=torch.float32,
            filename=os.path.join(ckpt_dir, f"confusion_{tag}.png"))
        metrics_log.log(step, count_eval_accuracy=acc)
        say(f"{what} counting-eval accuracy: {acc:.3f}")

    # The counting eval's held-out batch: the first of epoch 0.
    eval_batch = None
    if evaluating and writer:
        eval_batch = next(iter(pipeline.epoch(0)))
        if args.device_data:   # the eval needs pixels, not bank indices
            eval_batch = pipeline.materialize(eval_batch)

    profile = contextlib.ExitStack()
    profiling = {"active": False}
    skip_once = {"n": resume_skip}

    def batches(epoch):
        skip = skip_once.pop("n", 0)  # only the first resumed epoch
        for i, batch in enumerate(pipeline.epoch(epoch)):
            if i < skip:
                continue
            if args.profile_dir and writer and trainer.global_step == 2 \
                    and not profiling["active"]:
                profile.enter_context(trace_capture(args.profile_dir))
                profiling["active"] = True
            yield batch
            if profiling["active"] and trainer.global_step >= 4:
                profile.close()
                profiling["active"] = False
                print(f"profile trace written to {args.profile_dir}")
            # Steps are enqueued without a sync (the trainer reads the loss
            # only at log_every and epoch ends), so these ticks measure the
            # enqueue rate; the epoch lines carry the synced rates.
            rate = meter.tick(cfg.effective_batch_size)
            if rate:
                metrics_log.log(trainer.global_step,
                                pairs_per_sec_enqueue=rate)

    # SIGTERM → emergency checkpoint at the next step boundary and a clean
    # return; resume with --resume <ckpt-dir>/preempt.
    replaced = install_preemption_handler(trainer)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    result = {"trainer": trainer, "pipeline": pipeline, "history": [],
              "preempted": False, "image_path": image_path,
              "resumed_at_step": resumed_at, "start_epoch": start_epoch,
              "skipped_steps": resume_skip}
    try:
        # Evaluated before training too: the chance-level anchor of the
        # accuracy curve (not on resume; the anchor belongs to step 0).
        if evaluating and start_epoch == 0:
            count_eval("pretrain", 0, "pre-training")
        for epoch in range(start_epoch, args.epochs):
            out = trainer.train(batches, num_epochs=epoch + 1,
                                start_epoch=epoch,
                                log_fn=lambda msg: say(msg, flush=True))
            result["history"].extend(out["history"])
            if out["preempted"]:
                say(f"preempted: emergency checkpoint at "
                    f"{os.path.join(ckpt_dir, 'preempt')} "
                    f"(resume with --resume <that path>)")
                result["preempted"] = True
                return result
            if evaluating:
                count_eval(f"epoch_{epoch}", trainer.global_step,
                           f"epoch {epoch}")
    finally:
        if profiling["active"]:  # the run ended before the stop step
            profile.close()
            print(f"profile trace written to {args.profile_dir}")
        metrics_log.close()
        for sig, prev in replaced.items():
            if prev is not None:  # None: not installed from Python
                signal.signal(sig, prev)

    # The synced epoch timings; steady state = the epochs after the first,
    # which carries the first launches (cuBLAS and allocator warm-up).
    hist = result["history"]
    steady = hist[1:] or hist
    pairs = sum(h["seconds"] * h["pairs_per_sec"] for h in steady)
    secs = sum(h["seconds"] for h in steady)
    if device.type == "cuda":
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    say(f"done: best_loss={trainer.best_loss:.4f} "
        f"steps={trainer.global_step} "
        f"throughput={pairs / secs if secs else 0.0:.1f} pairs/s"
        + (f" over {world} ranks" if world > 1 else "/card")
        + (" (steady-state, first epoch excluded)" if len(hist) > 1
           else ""))
    if device.type == "cuda":
        say(f"device peak memory: "
            f"{result['peak_memory_bytes'] / 2**30:.2f} GiB "
            f"({torch.cuda.get_device_name(device)})")
    return result


if __name__ == "__main__":
    main()
