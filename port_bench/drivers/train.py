"""The training driver: the port's train step
(``train/engine.py::make_train_step``) run back to back for the window.

Set-up builds one step from the seed's weights (``weights.py``), with its
model, its optimizer and the pixel bank on the card, and drives it through
its first ``checked_steps`` steps, which are also its warm-up: the readings
the reference is held to are taken from them (each step's loss, the first
gradient as the optimizer got it, from its first moment, and each leaf's
change after the last checked step). The window then runs the same step on
the following batches until ``--seconds`` have passed and synchronizes:
``train_pairs_per_s`` is every pair of the window's steps over the time
from its first launch to that synchronize. ``--trace 1`` then profiles
``trace_steps`` more whole steps.

The objective is SPARC and the optimizer AdamSPD, constants of this driver:
the reference (``clip_ref.train_steps``), the FLOP count
(``flops.sparc_step_flops``) and the kernel calls (``calls_per_step``) are
theirs. Another objective or optimizer comes as a driver and a reference of
its own. The traffic file's keys, and no others: ``microbatch``, ``accum``, ``inverse_temperature``, ``amp``, ``pixel_bank`` (uint8 images
on the card; rows by ``pixel_index``), ``caption_tokens`` ([shortest,
longest] caption, BOS and EOS included, then padding), ``batches`` (step
batches drawn at set-up and cycled through), ``checked_steps``,
``trace_steps``.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import torch

from .. import flops, harness, spec, trace, weights
from ..reference import clip_ref

UNITS = {"setup_s": "s", "train_pairs_per_s": "pairs/s"}
LOSS, OPTIMIZER = "sparc", "adamspd"
KEYS = {"driver", "name", "microbatch", "accum", "inverse_temperature", "amp",
        "pixel_bank", "caption_tokens", "batches", "checked_steps",
        "trace_steps"}


def port_config(cfg: dict):
    """The port's ``CLIPConfig`` at the configuration file's widths."""
    from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                             TextConfig,
                                                             VisionConfig)
    v, t = cfg["vision_config"], cfg["text_config"]
    return CLIPConfig(
        vision=VisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"],
            hidden_size=v["hidden_size"],
            intermediate_size=v["intermediate_size"],
            num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"],
            layer_norm_eps=v["layer_norm_eps"]),
        text=TextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            intermediate_size=t["intermediate_size"],
            num_layers=t["num_hidden_layers"],
            num_heads=t["num_attention_heads"],
            max_position_embeddings=t["max_position_embeddings"],
            layer_norm_eps=t["layer_norm_eps"],
            pad_token_id=t["pad_token_id"], bos_token_id=t["bos_token_id"],
            eos_token_id=t["eos_token_id"]),
        projection_dim=cfg["projection_dim"],
        logit_scale_init=cfg["logit_scale_init_value"])


def train_config(cfg: dict, tr: dict, quant: str = "none"):
    from clip_finegrained_alignment_tpu_torch.config import TrainConfig
    return TrainConfig(
        clip_model=cfg.get("port_model", "ViT-B/16"), loss_type=LOSS,
        optimizer_type=OPTIMIZER,
        inverse_temperature=tr["inverse_temperature"],
        batch_size=tr["microbatch"],
        gradient_accumulation_steps=tr["accum"], use_amp=tr["amp"],
        quant=quant)


def traffic_keys(tr: dict) -> None:
    """Refuse a traffic file with a key this driver does not read (such as
    a ``loss`` or ``optimizer`` it would not run)."""
    extra = sorted(set(tr) - KEYS)
    if extra:
        raise harness.Refused(f"the train driver runs {LOSS} + {OPTIMIZER} "
                              f"and reads no {extra} (traffic {tr['name']!r})")


def optimizer_settings(tcfg) -> dict:
    """What the reference needs of the train config."""
    return {"lr": tcfg.lr, "betas": tuple(tcfg.betas), "eps": tcfg.eps,
            "weight_decay": tcfg.weight_decay,
            "max_grad_norm": tcfg.max_grad_norm,
            "inverse_temperature": tcfg.inverse_temperature,
            "similarity_threshold": tcfg.similarity_threshold,
            "global_loss_weight": tcfg.global_loss_weight,
            "local_loss_weight": tcfg.local_loss_weight}


def inputs(cfg: dict, tr: dict, seed: int, dev) -> dict:
    """The seed's weights, pixel bank, and ``batches`` step batches
    (``pixel_index`` [K, accum, B], ``input_ids`` [K, accum, B, T]), all on
    the device, in this order from one generator."""
    v, t = cfg["vision_config"], cfg["text_config"]
    g = weights.generator(seed, dev)
    sd = weights.state_dict(cfg, g, dev)
    S, N = v["image_size"], tr["pixel_bank"]
    bank = torch.randint(0, 256, (N, S, S, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    K, A, B = tr["batches"], tr["accum"], tr["microbatch"]
    rows = K * A * B
    perms = [torch.randperm(N, generator=g, device=dev)
             for _ in range(-(-rows // N))]
    index = torch.cat(perms)[:rows].view(K, A, B).to(torch.int32)
    T = t["max_position_embeddings"]
    lo, hi = tr["caption_tokens"]
    length = torch.randint(lo, hi + 1, (K, A, B, 1), generator=g, device=dev)
    words = torch.randint(2, t["bos_token_id"], (K, A, B, T), generator=g,
                          device=dev)
    pos = torch.arange(T, device=dev)
    ids = torch.where(pos < length - 1, words, t["pad_token_id"])
    ids = torch.where(pos == length - 1, t["eos_token_id"], ids)
    ids = torch.where(pos == 0, t["bos_token_id"], ids).to(torch.int32)
    return {"sd": sd, "bank": bank, "index": index, "ids": ids}


def batch(data: dict, s: int) -> dict:
    k = s % data["index"].shape[0]
    return {"pixel_index": data["index"][k], "input_ids": data["ids"][k]}


def build(cfg: dict, tr: dict, data: dict, dev, quant: str = "none"):
    """The port's model, optimizer and step from ``data``'s weights."""
    from clip_finegrained_alignment_tpu_torch.models import clip as m
    from clip_finegrained_alignment_tpu_torch.optim.factory import \
        make_optimizer
    from clip_finegrained_alignment_tpu_torch.train.engine import \
        make_train_step
    pcfg, tcfg = port_config(cfg), train_config(cfg, tr, quant)
    model = m.build_train_model(pcfg, data["sd"], device=dev)
    opt = make_optimizer(tcfg, model.named_parameters())
    step = make_train_step(tcfg, pcfg, model, opt, pixel_bank=data["bank"])
    return model, opt, step, tcfg


def checked_steps(model, opt, step, data: dict, n: int, b1: float) -> dict:
    """The first ``n`` steps, read as the reference reads its own: each
    step's loss, the first gradient as the optimizer got it (its first
    moment after one step over 1 − β₁; zero where it holds none) and each
    leaf's change from the seed's weights after the last step."""
    params = dict(model.named_parameters())
    state = opt.optimizer.state
    losses, grads = [], None
    for s in range(n):
        losses.append(step(batch(data, s))["total_loss"])
        if s == 0:
            grads = {k: state[p]["exp_avg"] / (1 - b1) if "exp_avg" in state[p]
                     else torch.zeros_like(p) for k, p in params.items()}
    change = _norms({k: p.detach() - data["sd"][k] for k, p in params.items()})
    return {"losses": [float(x) for x in losses], "grads": grads,
            "change_norms": change}


def reference_readings(cfg: dict, tr: dict, tcfg, seed: int, dev,
                       n: int) -> dict:
    """The reference's first ``n`` steps on the seed's weights and batches,
    made again from the seed."""
    data = inputs(cfg, tr, seed, dev)
    batches = [{"pixels": data["bank"][batch(data, s)["pixel_index"].long()],
                "ids": batch(data, s)["input_ids"]} for s in range(n)]
    sd0 = data["sd"]
    del data
    ref = clip_ref.train_steps(sd0, cfg, optimizer_settings(tcfg), batches)
    ref["change_norms"] = _norms(ref.pop("changes"))
    return ref


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(leaves)
    return dict(zip(names, torch.stack(
        [leaves[k].float().norm() for k in names]).tolist()))


def _worst_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def compare(prog: dict, ref: dict, moved_rule: float = 1e-3) -> dict:
    """The numbers held against the reference (each the larger the worse):

    * ``loss_gap``: the largest relative gap of a checked step's loss;
    * ``grad_gap``: the worst leaf's gap between the norms of the first
      gradient (``_worst_gap``);
    * ``change_gap``: the same of each leaf's change after the last checked
      step, over the leaves the reference moves: those whose reference
      gradient is at least ``moved_rule`` of the median leaf's (the others,
      such as a key bias under softmax, move by round-off alone);
    * ``change_med``: the median over those leaves of the same gap;
    * ``grad_angle``: the median over those leaves of 1 − the cosine between
      the program's and the reference's first gradient.
    """
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                    ref["losses"]))
    g_ref, g_prog = _norms(ref["grads"]), _norms(prog["grads"])
    g_med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= moved_rule * g_med]
    cos = torch.stack([
        torch.nn.functional.cosine_similarity(
            prog["grads"][k].flatten().float(), ref["grads"][k].flatten(),
            dim=0) for k in moved]).tolist()
    c_prog, c_ref = prog["change_norms"], ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in moved)
    change = [abs(c_prog[k] - c_ref[k]) / max(c_ref[k], c_med) for k in moved]
    return {"loss_gap": loss,
            "grad_gap": _worst_gap(g_prog, g_ref, list(g_ref)),
            "change_gap": max(change),
            "change_med": statistics.median(change),
            "grad_angle": statistics.median(1.0 - c for c in cos)}


def calls_per_step(cfg: dict, tr: dict) -> Dict[str, List[dict]]:
    """Each kernel role's calls in one step, by shape (``kernels/counts.py``)."""
    v, t = cfg["vision_config"], cfg["text_config"]
    A, B = tr["accum"], tr["microbatch"]
    dt = "bf16" if tr["amp"] else "fp32"
    Sv, T = flops.vision_tokens(cfg), t["max_position_embeddings"]
    vis = {"B": B, "S": Sv, "H": v["num_attention_heads"],
           "D": v["hidden_size"] // v["num_attention_heads"], "dt": dt,
           "lse": True}
    txt = {"B": B, "S": T, "H": t["num_attention_heads"],
           "D": t["hidden_size"] // t["num_attention_heads"], "dt": dt,
           "lse": True, "bias": T * T}
    att = [vis] * (v["num_hidden_layers"] * A) \
        + [txt] * (t["num_hidden_layers"] * A)
    sparc = [{"B": B, "T": T, "P": Sv, "E": cfg["projection_dim"]}] * A
    return {"attention_fwd": att, "attention_bwd": att, "sparc_fwd": sparc,
            "sparc_bwd": sparc}


def release() -> None:
    """Return the freed program state's memory to the card."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def run(cell: dict, seed: int, seconds: float, traced: bool, dev,
        process_start: float) -> harness.Outcome:
    cfg, tr = cell["config"], cell["traffic"]
    traffic_keys(tr)
    n_checked = tr["checked_steps"]
    pairs = tr["microbatch"] * tr["accum"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    phases = {"imports": time.time() - process_start}
    data = inputs(cfg, tr, seed, dev)
    harness.synchronize(dev)
    phases["inputs"] = time.time() - process_start
    model, opt, step, tcfg = build(cfg, tr, data, dev)
    harness.synchronize(dev)
    phases["build"] = time.time() - process_start
    prog = checked_steps(model, opt, step, data, n_checked, tcfg.betas[0])
    phases["checked_steps"] = time.time() - process_start

    harness.synchronize(dev)
    window_start = time.time()
    t0 = time.perf_counter()
    s = n_checked
    while True:
        metrics = step(batch(data, s))
        s += 1
        if time.perf_counter() - t0 >= seconds:
            break
    harness.synchronize(dev)
    window_s = time.perf_counter() - t0
    steps = s - n_checked
    last = {k: float(x) for k, x in metrics.items()}

    tr_data = gaps = None
    if traced:
        prof = trace.profile()
        t = time.perf_counter()
        for _ in range(tr["trace_steps"]):
            step(batch(data, s))
            s += 1
        harness.synchronize(dev)
        slice_s = time.perf_counter() - t
        prof.stop()
        tr_data = trace.read(prof, slice_s)
        prof = trace.profile(cpu=True)
        with torch.profiler.record_function(trace.SLICE):
            step(batch(data, s))
            harness.synchronize(dev)
        prof.stop()
        gaps = trace.idle_gaps(prof)
        del prof
    device = harness.device_fields(dev, cell["chips"])
    del model, opt, step, data, metrics
    release()

    ref = reference_readings(cfg, tr, tcfg, seed, dev, n_checked)
    readings = compare(prog, ref)
    limits = cell["limits"]
    checks = {k: harness.check(readings[k], v) for k, v in limits.items()}
    failed = 0 if all(map(math.isfinite, last.values())) else steps

    step_flops = flops.sparc_step_flops(cfg, pairs)
    breakdown = None
    if traced:
        ctx = {"kind": "train", "trace": tr_data, "units": tr["trace_steps"],
               "calls_per_unit": calls_per_step(cfg, tr),
               "kernels": spec.kernel_impls(),
               "window_flops": step_flops * steps, "window_s": window_s}
        metrics_out = harness.per_layer(ctx)
        device.update(busy_s=tr_data["busy_s"],
                      window_s=tr_data["window_s"])
        breakdown = {"device_ops": trace.device_ops(tr_data),
                     "idle_gaps": gaps}
    else:
        metrics_out = {
            "train_pairs_per_s": {"value": pairs * steps / window_s,
                                  "unit": UNITS["train_pairs_per_s"]},
            "setup_s": {"value": window_start - process_start,
                        "unit": UNITS["setup_s"]}}
    return harness.Outcome(
        attempted=steps, failed=failed, metrics=metrics_out, device=device,
        checks=checks, breakdown=breakdown,
        notes={"setup_phases": phases, "readings": readings,
               "window_steps": steps,
               "window_s": window_s,
               "last_loss": last.get("total_loss")})


def half_batch(engine):
    """A fault for the calibration and the tests: each microbatch's loss
    over its first half of the rows alone (the mean over the rest)."""
    whole = engine.compute_loss

    def halved(model, b, *args, **kwargs):
        return whole(model, {k: x[: x.shape[0] // 2] for k, x in b.items()},
                     *args, **kwargs)
    engine.compute_loss = halved
    return lambda: setattr(engine, "compute_loss", whole)


def calibrate(cell: dict, seeds: List[int], modes: List[str], dev) -> List[dict]:
    """The compared numbers of each seed's checked steps, for each mode:
    ``program`` (as the window runs it), ``control`` (the port's own int8
    path, ``quant="int8"``: one precision below bf16) and ``half_batch``
    (:func:`half_batch`), each against the reference of that seed."""
    from clip_finegrained_alignment_tpu_torch.train import engine
    cfg, tr = cell["config"], cell["traffic"]
    traffic_keys(tr)
    n = tr["checked_steps"]
    out = []
    for seed in seeds:
        progs = {}
        for mode in modes:
            undo = half_batch(engine) if mode == "half_batch" else None
            data = inputs(cfg, tr, seed, dev)
            model, opt, step, tcfg = build(
                cfg, tr, data, dev, "int8" if mode == "control" else "none")
            progs[mode] = checked_steps(model, opt, step, data, n,
                                        tcfg.betas[0])
            if undo:
                undo()
            del model, opt, step, data
            release()
        ref = reference_readings(cfg, tr, tcfg, seed, dev, n)
        for mode, prog in progs.items():
            out.append({"seed": seed, "mode": mode, **compare(prog, ref)})
        del progs, ref
        release()
    return out
