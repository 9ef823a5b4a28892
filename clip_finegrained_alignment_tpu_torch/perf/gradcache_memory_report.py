"""GradCache's device memory on the card, the port of the JAX package's
``perf/gradcache_memory_report.py`` (which reads XLA's buffer assignment):
the peak of ``torch.cuda.max_memory_allocated`` over one train step of
ViT-B/16 at full width (SPARC + AdamSPD, bf16 on fp32 master weights,
inverse temperature 0.07, random weights from seed 0), three ways at the
same effective batch:

* direct: one chunk of accum·B, the only other way to one loss over the
  whole pool;
* gradcache: the same loss, chunked (``train/gradcache.py``);
* accum: plain accumulation (a loss a microbatch), the floor GradCache
  should match.

    python -m clip_finegrained_alignment_tpu_torch.perf.gradcache_memory_report

Run from the repository root on the card. For each pool (microbatch x
accum: 32 x 8 and 32 x 32) it prints one JSON line per variant: the peak
memory of the second step (the first warms cuBLAS and the allocator), the
step ms (CUDA events), the loss, or the OOM where the variant does not
fit; then the card's name and power limit. The peak includes the model,
its gradients, AdamSPD's state (anchors, moments) and the batch on the
device, which every variant holds alike.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess

POOLS = ((32, 8), (32, 32))
VARIANTS = ("accum", "gradcache", "direct")


def measure(model, opt, cfg, model_cfg, batch) -> dict:
    """Two steps of ``cfg`` on ``batch``: the second's peak memory and ms,
    or the OOM."""
    import torch
    from ..train.engine import make_train_step
    step = make_train_step(cfg, model_cfg, model, opt)
    try:
        step(batch)["total_loss"].item()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        loss = step(batch)["total_loss"]
        t1.record()
        torch.cuda.synchronize()
        return {"peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "step_ms": t0.elapsed_time(t1), "loss": loss.item()}
    except torch.cuda.OutOfMemoryError as e:     # the measurement itself
        return {"oom": str(e).splitlines()[0][:200],
                "peak_memory_gb_before_oom":
                torch.cuda.max_memory_allocated() / 1e9}
    finally:
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()


def main() -> list:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the report measures the card")
    from ..config import CLIPConfig, TrainConfig
    from ..models import clip as tm
    from ..models import convert
    from ..optim.factory import make_optimizer

    model_cfg = CLIPConfig.vit_b16()
    model = tm.build_train_model(
        model_cfg, convert.state_dict_from_jax(
            convert.random_params(model_cfg, 0), model_cfg), device="cuda")
    rows = []
    for b, accum in POOLS:
        cfg = TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                          inverse_temperature=0.07, batch_size=b,
                          gradient_accumulation_steps=accum, use_amp=True)
        rng = np.random.default_rng(0)
        v, t = model_cfg.vision, model_cfg.text
        ids = rng.integers(1, t.vocab_size - 2,
                           size=(accum, b, t.max_position_embeddings))
        ids[..., -1] = t.eos_token_id
        batch = {"input_ids": torch.from_numpy(ids.astype(np.int32)).cuda(),
                 "pixel_values": torch.from_numpy(rng.normal(
                     size=(accum, b, v.image_size, v.image_size, 3)
                 ).astype(np.float32)).cuda()}
        flat = {k: x.reshape((1, accum * b) + x.shape[2:])
                for k, x in batch.items()}
        for variant in VARIANTS:
            run_cfg = {"accum": cfg,
                       "gradcache": dataclasses.replace(cfg, grad_cache=True),
                       "direct": dataclasses.replace(
                           cfg, batch_size=accum * b,
                           gradient_accumulation_steps=1)}[variant]
            opt = make_optimizer(run_cfg, model.named_parameters())
            row = {"variant": variant, "microbatch": b, "accum": accum,
                   "pool": accum * b, **measure(
                       model, opt, run_cfg, model_cfg,
                       flat if variant == "direct" else batch)}
            del opt
            torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
            rows.append(row)
        del batch, flat
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return rows


if __name__ == "__main__":
    main()
