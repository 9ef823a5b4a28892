"""One-time dataset packing CLI, the port of
``clip_finegrained_alignment_tpu/cli/pack_dataset.py``: annotations JSON →
decode-free ``.npy`` pack for ``cli.train --packed`` (``data/packed.py``)::

    python -m clip_finegrained_alignment_tpu_torch.cli.pack_dataset \
        --annotations data/synthetic/synthetic_annotations.json \
        --output data/synthetic_packed --model ViT-B/16 --loss-type sparc
    python -m clip_finegrained_alignment_tpu_torch.cli.train \
        --packed data/synthetic_packed --model ViT-B/16 --loss-type sparc

It runs on the host only; no device is involved.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--annotations", required=True,
                   help="synthetic_annotations.json path")
    p.add_argument("--output", required=True, help="pack directory to write")
    p.add_argument("--model", default="ViT-B/32",
                   help="model whose image size / context length the pack "
                        "targets (ViT-B/32 | ViT-B/16 | ViT-L/14 | tiny)")
    p.add_argument("--loss-type", default="sparc",
                   choices=["clip", "sparc", "count", "clip_count"],
                   help="count packs the 9 counterfactual captions too "
                        "and pads images to square; the others pack "
                        "center-crop geometry")
    p.add_argument("--bpe-path", default=None,
                   help="CLIP BPE vocab (see cli.train --bpe-path)")
    p.add_argument("--chunk", type=int, default=64,
                   help="images decoded per assembler call")
    p.add_argument("--use-native", default="auto",
                   choices=["auto", "always", "never"],
                   help="C++ batch assembler for the decode (native/)")
    args = p.parse_args(argv)

    from ..config import CLIPConfig
    from ..data.packed import pack_dataset
    from ..data.tokenizer import HashTokenizer, load_tokenizer

    model_cfg = CLIPConfig.from_name(args.model)
    tokenizer = load_tokenizer(args.bpe_path)
    if isinstance(tokenizer, HashTokenizer) and \
            tokenizer.vocab_size != model_cfg.text.vocab_size:
        tokenizer = HashTokenizer(
            vocab_size=model_cfg.text.vocab_size,
            bos_token_id=model_cfg.text.bos_token_id,
            eos_token_id=model_cfg.text.eos_token_id,
            pad_token_id=model_cfg.text.pad_token_id)
    mode = "counterfactual" if args.loss_type == "count" else "standard"
    meta = pack_dataset(
        args.annotations, args.output, mode=mode,
        image_size=model_cfg.vision.image_size,
        context_length=model_cfg.text.max_position_embeddings,
        tokenizer=tokenizer, use_native=args.use_native,
        chunk_size=args.chunk, log_every=10)
    import os
    total = sum(os.path.getsize(os.path.join(args.output, f))
                for f in os.listdir(args.output))
    print(f"packed {meta['num_samples']} samples (mode={meta['mode']}, "
          f"{meta['image_size']}px, T={meta['context_length']}) -> "
          f"{args.output} ({total / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
