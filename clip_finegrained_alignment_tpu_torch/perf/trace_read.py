"""Device time by kernel from a ``torch.profiler`` trace, read from its raw
records (``chip_smoke.py``'s ``kernel_table`` uses :func:`device_rows`).

``prof.key_averages()`` builds a Python object a record before it
groups them: a train step's trace holds ~300,000 records (its aten ops,
their launches and ~50,000 kernels), and that read takes tens of
seconds. :func:`device_rows` loops over the raw records once and keeps
the same rows: device records not named after a CPU op (the CPU-side
aten ops carry the same device time again, and so do the GPU-timeline
annotations named after them).

On the card, one ViT-B/16 SPARC + AdamSPD step (32 × 8, bf16) traced once
and read both ways, the totals and the seconds each read takes (~1 min)::

    python -m clip_finegrained_alignment_tpu_torch.perf.trace_read
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import List, Tuple


def device_rows(prof) -> List[Tuple[float, str, int]]:
    """(µs, name, records) of each device kernel, memcpy or memset name in
    a finished ``torch.profiler.profile``, largest first."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    cpu_ops = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    by_name = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name() in cpu_ops:
            continue
        us, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (us + (e.end_ns() - e.start_ns()) / 1e3, n + 1)
    rows = [(us, k, c) for k, (us, c) in by_name.items() if us > 0]
    rows.sort(reverse=True)
    return rows


def key_average_rows(prof) -> List[Tuple[float, str, int]]:
    """The same rows through ``key_averages()`` (the slow read)."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    cpu_ops = {e.key for e in avgs if e.device_type == DeviceType.CPU}
    rows = [(e.self_device_time_total, e.key, e.count) for e in avgs
            if e.device_type == DeviceType.CUDA and e.key not in cpu_ops
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    return rows


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..config import CLIPConfig, TrainConfig
    from ..models import clip as m
    from ..models.convert import random_params, state_dict_from_jax
    from ..optim.factory import make_optimizer
    from ..train.engine import make_train_step
    from .data_parallel_check import global_batch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    cfg = CLIPConfig.vit_b16()
    tcfg = TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                       inverse_temperature=0.07, batch_size=32,
                       gradient_accumulation_steps=8, use_amp=True)
    model = m.build_train_model(
        cfg, state_dict_from_jax(random_params(cfg, 0), cfg), device="cuda")
    step = make_train_step(tcfg, cfg, model,
                           make_optimizer(tcfg, model.named_parameters()))
    batch = {k: torch.from_numpy(x).cuda()
             for k, x in global_batch(cfg, 8, 32, 0).items()}
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    out = {"gpu": card, "trace_s": time.time() - t0,
           "records": len(prof.profiler.kineto_results.events())}
    for name, read in (("raw", device_rows), ("key_averages",
                                              key_average_rows)):
        t0 = time.time()
        rows = read(prof)
        out[name] = {"read_s": time.time() - t0,
                     "device_ms": sum(r[0] for r in rows) / 1e3,
                     "kernel_calls": sum(r[2] for r in rows),
                     "names": len(rows)}
    raw = {k: (us, c) for us, k, c in device_rows(prof)}
    avg = {k: (us, c) for us, k, c in key_average_rows(prof)}
    out["same_names"] = raw.keys() == avg.keys()
    out["same_calls"] = all(raw[k][1] == avg[k][1] for k in raw
                            if k in avg)
    out["max_abs_us_by_name"] = max(abs(raw[k][0] - avg[k][0])
                                    for k in raw if k in avg)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
