"""Evaluation CLI, the port of ``clip_finegrained_alignment_tpu/cli/
evaluate.py``: the three benchmark protocols behind one subcommand each::

    python -m clip_finegrained_alignment_tpu_torch.cli.evaluate countbench \\
        --model ViT-B/16 --checkpoint checkpoints/clip_finetune/best \\
        --dataset procedural
    python -m clip_finegrained_alignment_tpu_torch.cli.evaluate vlmsblind \\
        --model ViT-B/16 --dataset vlmsblind.json --confidence 0.25
    python -m clip_finegrained_alignment_tpu_torch.cli.evaluate crop \\
        --model ViT-B/16 --samples 500

It runs on the card in fp32 unless ``--device cpu`` is given; with no card
it fails, it does not fall back.

``--checkpoint`` / ``--pretrained`` take a reference ``.pt`` / ``.pth`` /
``.bin`` (HF names), or a checkpoint directory that the port's
``cli/train.py`` wrote (``best/``, ``epoch_{n}/``, ``preempt/``), where the
JAX CLI reads an orbax directory. With neither, the weights are
``models/convert.py::random_params(cfg, 0)`` (numpy), not ``jax.random``.
HF model names and the HF hub datasets are downloads, out of reach: they
raise ``SystemExit``. ``--dataset procedural`` generates a local fixture
(``data/fixtures.py``) and ``crop`` without ``--coco-dir`` samples
``ProceduralObjectSource``, so every subcommand runs with no download.

Left out, against the JAX CLI: ``--pallas`` (a TPU switch; the card always
runs the port's kernels) and ``--data-parallel`` (the multi-GPU slice).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--model", default="ViT-B/32")
        sp.add_argument("--checkpoint", default=None,
                        help="reference .pt/.pth/.bin or a checkpoint "
                             "directory of cli/train.py (best/, epoch_N/, "
                             "preempt/)")
        sp.add_argument("--pretrained", default=None,
                        help="as --checkpoint (default: random weights)")
        sp.add_argument("--batch-size", type=int, default=32)
        sp.add_argument("--output-dir", default="eval_results")
        sp.add_argument("--bpe-path", default=None)
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")

    cb = sub.add_parser("countbench")
    common(cb)
    cb.add_argument("--confidence", type=float, default=0.2)
    cb.add_argument("--margin", type=float, default=0.01)
    cb.add_argument("--format", default="word",
                    choices=["numeric", "word", "both"])
    cb.add_argument("--position", default="first",
                    choices=["first", "random"])
    cb.add_argument("--dataset", default=None,
                    help="local JSON, or procedural (a generated fixture)")
    cb.add_argument("--debug-dir", default=None,
                    help="dump per-sample image + probability plots here")
    cb.add_argument("--samples", type=int, nargs="*", default=None,
                    help="sample indices to debug (default: all when "
                         "--debug-dir is set)")

    vb = sub.add_parser("vlmsblind")
    common(vb)
    vb.add_argument("--confidence", type=float, default=0.25)
    vb.add_argument("--margin", type=float, default=0.01)
    vb.add_argument("--dataset", default=None,
                    help="local JSON, or procedural (a generated fixture)")

    cr = sub.add_parser("crop")
    common(cr)
    cr.add_argument("--coco-dir", default=None,
                    help="COCO root (omit for the procedural source)")
    cr.add_argument("--samples", type=int, default=500)
    cr.add_argument("--white-square", action="store_true")
    cr.add_argument("--output", default="crop_evaluation_results.json")
    cr.add_argument("--debug-dir", default=None,
                    help="save per-condition bbox-overlay PNGs per sample")
    return p


def load_params(args, model_cfg):
    """The HF-named state dict of ``--checkpoint`` or ``--pretrained``: a
    reference ``.pt``, a port checkpoint directory's ``state.pt``
    ``"model"``, or, with neither, random weights."""
    from ..models import convert

    src = args.checkpoint or args.pretrained
    if src is None:
        print("no checkpoint/pretrained given: RANDOM INIT (hermetic run)")
        return convert.state_dict_from_jax(
            convert.random_params(model_cfg, 0), model_cfg)
    if src.endswith((".pt", ".pth", ".bin")):
        state_dict, _ = convert.load_reference_checkpoint(src)
        print(f"loaded reference checkpoint {src}")
        return state_dict
    if os.path.isdir(src):
        from ..train.checkpoint import CheckpointManager
        path = os.path.abspath(src.rstrip("/"))
        state, _ = CheckpointManager(os.path.dirname(path)).restore(
            os.path.basename(path))
        print(f"loaded checkpoint directory {src}")
        return state["model"]
    raise SystemExit(f"{src!r}: not a local .pt/.pth/.bin file or "
                     "checkpoint directory; HF model names are a download, "
                     "out of reach (no network)")


def main(argv=None) -> Dict[str, Any]:
    """Run the CLI; returns the subcommand's metrics (``crop``: its
    ``aggregate_stats``)."""
    args = build_parser().parse_args(argv)

    from ..config import CLIPConfig
    from ..data.tokenizer import HashTokenizer, load_tokenizer
    from ..models import clip as m

    device = m.resolve_device(args.device)
    model_cfg = CLIPConfig.from_name(args.model)
    state_dict = load_params(args, model_cfg)
    tokenizer = load_tokenizer(args.bpe_path)
    if isinstance(tokenizer, HashTokenizer) and \
            tokenizer.vocab_size != model_cfg.text.vocab_size:
        # The hash tokenizer's ids must fit the model's vocabulary (an
        # out-of-range id would fail the embedding lookup).
        tokenizer = HashTokenizer(
            vocab_size=model_cfg.text.vocab_size,
            bos_token_id=model_cfg.text.bos_token_id,
            eos_token_id=model_cfg.text.eos_token_id,
            pad_token_id=model_cfg.text.pad_token_id)

    # "procedural": generate a local benchmark-shaped fixture, so the whole
    # pipeline runs with no network (a plumbing check, not the benchmark).
    if getattr(args, "dataset", None) == "procedural":
        from ..data import fixtures
        fix_dir = os.path.join(args.output_dir, "fixture")
        if args.command == "countbench":
            fixtures.make_countbench_fixture(fix_dir)
            args.dataset = os.path.join(fix_dir, "countbench_fixture.json")
        else:
            fixtures.make_vlmsblind_fixture(fix_dir)
            args.dataset = os.path.join(fix_dir, "vlmsblind_fixture.json")
        print(f"generated procedural fixture: {args.dataset}")

    if args.command == "countbench":
        from ..eval.countbench import CountBenchEvaluator, load_countbench
        samples = load_countbench(args.dataset)
        ev = CountBenchEvaluator(
            state_dict, model_cfg, confidence=args.confidence,
            margin=args.margin, number_format=args.format,
            template_position=args.position, tokenizer=tokenizer,
            batch_size=args.batch_size, device=device,
            debug_dir=args.debug_dir, samples_of_interest=args.samples)
        results = ev.evaluate_dataset(samples)
        metrics = ev.compute_metrics(results)
        ev.save_results(results, metrics, args.output_dir)
        print(json.dumps(metrics, indent=2))
        return metrics

    if args.command == "vlmsblind":
        from ..eval.vlmsblind import VLMsBlindEvaluator, load_vlmsblind
        samples = load_vlmsblind(args.dataset)
        ev = VLMsBlindEvaluator(
            state_dict, model_cfg, confidence=args.confidence,
            margin=args.margin, tokenizer=tokenizer,
            batch_size=args.batch_size, device=device)
        metrics = ev.run_all_tasks(samples, output_dir=args.output_dir)
        print(json.dumps(metrics, indent=2))
        return metrics

    from ..eval.crop_detection import (CocoObjectSource,
                                       CropDetectionEvaluator,
                                       ProceduralObjectSource)
    source = CocoObjectSource(args.coco_dir) if args.coco_dir \
        else ProceduralObjectSource()
    ev = CropDetectionEvaluator(
        state_dict, model_cfg, tokenizer=tokenizer,
        batch_size=args.batch_size, device=device,
        use_white_square=args.white_square)
    results = ev.run_evaluation(source, num_samples=args.samples,
                                debug_dir=args.debug_dir)
    ev.save(results, args.output)
    print("\nEvaluation Summary:")
    for cond, stats in results["aggregate_stats"].items():
        print(f"{cond}: accuracy {stats['accuracy']:.2%} "
              f"(pos {stats['avg_positive']:.3f} / "
              f"neg {stats['avg_negative']:.3f})")
    return results["aggregate_stats"]


if __name__ == "__main__":
    main()
