"""Training CLI, the port of ``clip_finegrained_alignment_tpu/cli/train.py``
on one card: the loss and optimizer flags pick the behaviour, the data
flags the ingest (live decode of an annotations file, or a packed dataset
with its pixels kept on the device).

Example::

    python -m clip_finegrained_alignment_tpu_torch.cli.train \\
        --packed data/synthetic_packed --device-data --model ViT-B/16 \\
        --loss-type sparc --optimizer adamspd --epochs 10 \\
        --experiment-name sparc_spd_b16

It runs on the card unless ``--device cpu`` is given; with no card it
fails, it does not fall back. ``--resume`` restores ``best/`` (or the
checkpoint directory given) step-exact: the interrupted epoch's completed
steps are skipped, not trained again.

Left out, against the JAX CLI: the TPU knobs (``--pallas``,
``--fused-sparc``, ``--remat``, ``--unroll-*``, ``--unstack-layers``,
``--quant``) and the mesh flags, which the multi-GPU slice brings.
Refused until its slice: ``--import-optimizer-state`` (interop).
``--eval-every-epoch`` (count loss only) holds out the first batch of
epoch 0 and runs ``eval/batch_eval.py::evaluate_batch`` on it in fp32 on
the trainer's master weights, before training (when the run starts at
epoch 0) and after every epoch, between the epochs' timings; it logs
``count_eval_accuracy`` and writes ``confusion_{pretrain|epoch_<n>}.png``
into the checkpoint directory. ``--pretrained`` takes a local
reference checkpoint only (``.pt``, ``.pth``, ``.bin``, HF names): HF
downloads are out of reach. Deliberate
differences: with no ``--pretrained`` the weights are
``models/convert.py::random_params(cfg, seed)`` (numpy), checkpoints are
torch files, and ``--profile-dir`` writes a ``torch.profiler`` trace.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
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
                        "HF names) to start from (default: random weights "
                        "from --seed)")
    p.add_argument("--import-optimizer-state", action="store_true",
                   help="refused: reference optimizer-state import waits "
                        "for the interop slice (ROADMAP A8)")
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
    """Exit non-zero on every flag whose slice is not ported, naming it."""
    if args.import_optimizer_state:
        raise SystemExit("--import-optimizer-state is not ported yet: the "
                         "reference optimizer-state import comes with the "
                         "interop slice (ROADMAP A8)")
    if args.pretrained and not args.pretrained.endswith(
            (".pt", ".pth", ".bin")):
        raise SystemExit(f"--pretrained {args.pretrained!r}: only a local "
                         "reference .pt checkpoint is accepted; HF "
                         "downloads are out of reach (no network)")
    if bool(args.packed) == bool(args.annotations):
        raise SystemExit("pass exactly one of --annotations / --packed")
    if args.device_data and not args.packed:
        raise SystemExit("--device-data requires --packed")


def main(argv=None) -> Dict[str, Any]:
    """Run the CLI; returns what a caller in the same process may check:
    the ``trainer``, the ``pipeline``, the epoch ``history``, whether the
    run was ``preempted``, the ``image_path`` of live decode ("native" or
    "PIL"), the resume point and the card's peak memory."""
    args = build_parser().parse_args(argv)
    _refuse(args)

    import torch

    from ..config import TrainConfig
    from ..data.datasets import (CounterfactualCaptionDataset,
                                 CountingDataPipeline,
                                 SyntheticCaptionDataset)
    from ..data.tokenizer import HashTokenizer, load_tokenizer
    from ..eval.batch_eval import evaluate_batch
    from ..models import clip as m
    from ..train.checkpoint import CheckpointManager
    from ..train.engine import Trainer, install_preemption_handler
    from ..utils.logging import MetricsLogger, ThroughputMeter, trace_capture

    device = m.resolve_device(args.device)
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
        log_every=args.log_every)
    cfg.print_config()
    model_cfg = cfg.model_config()

    # ---------------- data ----------------
    mode = "counterfactual" if args.loss_type == "count" else "standard"
    image_path = None
    if args.packed:
        from ..data.packed import PackedDataPipeline
        pipeline = PackedDataPipeline(
            args.packed, cfg.effective_batch_size, seed=cfg.seed,
            expect_mode=mode,
            expect_image_size=model_cfg.vision.image_size,
            expect_context_length=model_cfg.text.max_position_embeddings,
            index_only=args.device_data)
        print(f"packed dataset: {pipeline._num_samples()} samples, "
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
            dataset, cfg.effective_batch_size, mode=mode,
            image_size=model_cfg.vision.image_size,
            context_length=model_cfg.text.max_position_embeddings,
            tokenizer=tokenizer, seed=cfg.seed)
        image_path = "native" if pipeline._native else "PIL"
        print(f"dataset: {len(dataset)} samples, "
              f"{pipeline.steps_per_epoch()} steps/epoch, image decode: "
              f"{image_path}")

    # ---------------- weights ----------------
    state_dict = None
    if args.pretrained:
        from ..models.convert import load_reference_checkpoint
        state_dict, ref_meta = load_reference_checkpoint(args.pretrained)
        print(f"loaded reference checkpoint (step "
              f"{ref_meta.get('global_step')})")

    # ---------------- engine ----------------
    ckpt_dir = os.path.join(args.checkpoint_dir, args.experiment_name)
    manager = CheckpointManager(ckpt_dir, save_every=cfg.save_every)
    trainer = Trainer(cfg, state_dict, device=device,
                      checkpoint_manager=manager,
                      pixel_bank=pipeline.pixel_bank()
                      if args.device_data else None)

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
        print(f"resumed from {resume_dir}/{resume_which} at epoch "
              f"{start_epoch}"
              + (f" (skipping {resume_skip} completed steps)"
                 if resume_skip else ""))

    metrics_log = MetricsLogger(args.metrics_file)
    meter = ThroughputMeter()

    def count_eval(tag: str, step: int) -> float:
        acc, _, _ = evaluate_batch(
            trainer.model, model_cfg, eval_batch, dtype=torch.float32,
            filename=os.path.join(ckpt_dir, f"confusion_{tag}.png"))
        metrics_log.log(step, count_eval_accuracy=acc)
        return acc

    # The counting eval's held-out batch: the first of epoch 0.
    eval_batch = None
    if args.eval_every_epoch and mode == "counterfactual":
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
            if args.profile_dir and trainer.global_step == 2 \
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
        if eval_batch is not None and start_epoch == 0:
            acc = count_eval("pretrain", 0)
            print(f"pre-training counting-eval accuracy: {acc:.3f}")
        for epoch in range(start_epoch, args.epochs):
            out = trainer.train(batches, num_epochs=epoch + 1,
                                start_epoch=epoch,
                                log_fn=lambda msg: print(msg, flush=True))
            result["history"].extend(out["history"])
            if out["preempted"]:
                print(f"preempted: emergency checkpoint at "
                      f"{os.path.join(ckpt_dir, 'preempt')} "
                      f"(resume with --resume <that path>)")
                result["preempted"] = True
                return result
            if eval_batch is not None:
                acc = count_eval(f"epoch_{epoch}", trainer.global_step)
                print(f"epoch {epoch} counting-eval accuracy: {acc:.3f}")
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
    print(f"done: best_loss={trainer.best_loss:.4f} "
          f"steps={trainer.global_step} "
          f"throughput={pairs / secs if secs else 0.0:.1f} pairs/s/card"
          + (" (steady-state, first epoch excluded)" if len(hist) > 1
             else ""))
    if device.type == "cuda":
        print(f"device peak memory: "
              f"{result['peak_memory_bytes'] / 2**30:.2f} GiB "
              f"({torch.cuda.get_device_name(device)})")
    return result


if __name__ == "__main__":
    main()
