"""Export a checkpoint to the reference's torch ``.pt`` training format, the
port of ``clip_finegrained_alignment_tpu/cli/export_checkpoint.py``::

    python -m clip_finegrained_alignment_tpu_torch.cli.export_checkpoint \\
        --checkpoint checkpoints/clip_finetune/best --model ViT-B/16 \\
        --output best.pt --include-optimizer

The output holds ``model_state_dict``, ``global_step``, ``best_loss`` and
``config`` (and with ``--include-optimizer`` ``optimizer_state_dict``), as
the reference's trainers write it, so HF's ``CLIPModel.load_state_dict``,
the reference's evaluators and training resume, the JAX package's
``hf_import.load_reference_checkpoint`` and this port's ``--pretrained``
/ ``--checkpoint`` read it.

Sources: a checkpoint directory that the port's ``cli/train.py`` wrote
(``best/``, ``epoch_{n}/``, ``preempt/``: ``state.pt`` and ``meta.json``;
the metadata is read from the directory, else from its parent), or a
reference ``.pt`` (HF or OpenAI names), so the CLI also converts between
the two namings. ``--format openai`` writes the OpenAI ``clip``-package
names (the reference count trainer's resume format).
``--include-optimizer`` (hf only; a checkpoint directory) converts the
optimizer state, AdamSPD or AdamW, whichever the checkpoint holds, with
the hyperparameters of its saved config. It runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a checkpoint to the reference torch .pt format")
    p.add_argument("--checkpoint", required=True,
                   help="a checkpoint directory of cli/train.py, or a "
                        "reference .pt/.pth/.bin to convert")
    p.add_argument("--model", default="ViT-B/32",
                   help="model family (ViT-B/32, ViT-B/16, ViT-L/14, tiny)")
    p.add_argument("--output", required=True, help="output .pt path")
    p.add_argument("--format", default="hf", choices=["hf", "openai"],
                   help="state-dict naming: hf = CLIPModel names (the "
                        "SPARC/DDP trainers and evaluators), openai = "
                        "clip-package names (the count trainer's resume "
                        "format)")
    p.add_argument("--global-step", type=int, default=None,
                   help="override global_step (default: the checkpoint's "
                        "metadata, else 0)")
    p.add_argument("--include-optimizer", action="store_true",
                   help="also convert the optimizer state (AdamSPD moments, "
                        "step and anchors, or the two-group AdamW state), "
                        "making the file a complete training checkpoint. "
                        "Needs a checkpoint directory and --format hf")
    return p


def _read_meta(path: str) -> dict:
    """``meta.json`` of a checkpoint directory, else of its parent."""
    for d in (path, os.path.dirname(path.rstrip("/"))):
        mp = os.path.join(d, "meta.json")
        if os.path.exists(mp):
            with open(mp) as f:
                return json.load(f)
    return {}


def main(argv=None) -> dict:
    """Run the CLI; returns what was written: the path, the naming, the
    step and whether the optimizer state is in it."""
    args = build_parser().parse_args(argv)

    import torch

    from ..config import CLIPConfig, TrainConfig
    from ..models import convert

    model_cfg = CLIPConfig.from_name(args.model)
    src = args.checkpoint
    is_dir = os.path.isdir(src)
    if args.include_optimizer:
        if args.format != "hf":
            raise SystemExit("--include-optimizer requires --format hf "
                             "(the reference's optimizer state is keyed by "
                             "HF CLIPModel parameter order)")
        if not is_dir:
            raise SystemExit("--include-optimizer needs a checkpoint "
                             "directory (its state.pt holds the optimizer)")

    meta, opt_state = {}, None
    if is_dir:
        state_path = os.path.join(src, "state.pt")
        if not os.path.exists(state_path):
            raise SystemExit(f"{src}: no state.pt")
        state = torch.load(state_path, map_location="cpu", weights_only=True)
        state_dict, opt_state = state["model"], state.get("optimizer")
        meta = _read_meta(src)
    elif src.endswith((".pt", ".pth", ".bin")):
        state_dict, meta = convert.load_reference_checkpoint(src, model_cfg)
    else:
        raise SystemExit(f"{src!r}: not a checkpoint directory or a local "
                         ".pt/.pth/.bin file")

    opt_sd = None
    if args.include_optimizer:
        from ..optim import interop
        if opt_state is None:
            raise SystemExit(f"{src}: state.pt holds no optimizer state")
        tc = TrainConfig()     # the fallbacks of a config-less checkpoint
        saved = meta.get("config") or {}
        hp = dict(lr=saved.get("lr", tc.lr),
                  betas=tuple(saved.get("betas", tc.betas)),
                  eps=saved.get("eps", tc.eps),
                  weight_decay=saved.get("weight_decay", tc.weight_decay))
        if interop.is_adamspd_state(opt_state):
            opt_sd = interop.reference_optimizer_state_dict(
                opt_state, model_cfg,
                amsgrad=bool(saved.get("amsgrad", tc.amsgrad)), **hp)
        else:
            opt_sd = interop.reference_adamw_optimizer_state_dict(
                opt_state, model_cfg, **hp)

    step = args.global_step if args.global_step is not None \
        else int(meta.get("global_step", 0))
    convert.save_reference_checkpoint(
        args.output, state_dict, model_cfg, global_step=step,
        best_loss=float(meta.get("best_loss", float("inf"))),
        config=meta.get("config") or {}, optimizer_state_dict=opt_sd,
        fmt=args.format)
    print(f"wrote {args.output} (reference torch .pt, {args.format} names"
          + (", with optimizer state" if opt_sd is not None else "") + ")")
    return {"output": args.output, "format": args.format,
            "global_step": step, "optimizer": opt_sd is not None}


if __name__ == "__main__":
    main()
