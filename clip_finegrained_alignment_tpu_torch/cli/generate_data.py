"""Synthetic-data generation CLI, the port of
``clip_finegrained_alignment_tpu/cli/generate_data.py`` (same flags, same
files)::

    python -m clip_finegrained_alignment_tpu_torch.cli.generate_data \
        --procedural --num-samples 1000 --output-dir data/synthetic
    # or from a local COCO tree (annotations/ and train2017/ under it):
    python -m clip_finegrained_alignment_tpu_torch.cli.generate_data \
        --coco-dir dataset/coco --num-samples 50000

It runs on the host only; no device is involved.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coco-dir", default=None)
    p.add_argument("--procedural", action="store_true",
                   help="use the hermetic shape-compositing source")
    p.add_argument("--output-dir", default="synthetic_dataset")
    p.add_argument("--num-samples", type=int, default=1000)
    p.add_argument("--max-objects", type=int, default=10)
    p.add_argument("--size-category", default="small",
                   choices=["small", "medium", "large"])
    p.add_argument("--annotation-mode", default="count",
                   choices=["count", "integer", "full"])
    p.add_argument("--image-size", type=int, default=224,
                   help="procedural-source frame size")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--visualize", type=int, default=0, metavar="N",
                   help="render the first N generated samples with their "
                        "bbox overlays to <output-dir>/viz/ (reference "
                        "visualize_sample, gen_synthetic_data.py:347-378)")
    args = p.parse_args(argv)

    from ..data.synthetic import (CocoSource, ProceduralSource,
                                  SyntheticCountGenerator,
                                  visualize_dataset)

    if args.procedural or not args.coco_dir:
        source = ProceduralSource(args.image_size)
        print("using procedural source (no COCO)")
    else:
        source = CocoSource(args.coco_dir)
        print(f"using COCO source: {args.coco_dir}")

    gen = SyntheticCountGenerator(source, args.output_dir)
    anns = gen.generate(args.num_samples, max_objects=args.max_objects,
                        category=args.size_category,
                        annotation_mode=args.annotation_mode,
                        seed=args.seed)
    print(f"wrote {len(anns)} samples to {args.output_dir}/"
          f"synthetic_annotations.json")

    if args.visualize > 0:
        import os
        paths = visualize_dataset(
            anns, os.path.join(args.output_dir, "viz"),
            num_samples=args.visualize,
            show_integers=(args.annotation_mode == "integer"))
        print(f"wrote {len(paths)} bbox-overlay previews to "
              f"{args.output_dir}/viz/")


if __name__ == "__main__":
    main()
