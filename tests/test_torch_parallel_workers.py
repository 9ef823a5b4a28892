"""Rank functions of the port's multi-process tests
(``test_torch_parallel.py``, ``test_torch_parallel_cli.py``,
``test_torch_model_parallel.py``), run by
``parallel/launch.py::spawn`` in W gloo processes on the CPU; this module
holds no test. Kept apart from the test files: spawn imports a rank
function's module in every worker, and this one imports torch and the
port only (no JAX). Each returns numpy, gathered by rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                         MeshConfig,
                                                         TrainConfig)
from clip_finegrained_alignment_tpu_torch.models import clip as tm
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.optim.factory import \
    make_optimizer
from clip_finegrained_alignment_tpu_torch.parallel import mesh as pmesh
from clip_finegrained_alignment_tpu_torch.train.checkpoint import \
    CheckpointManager
from clip_finegrained_alignment_tpu_torch.train.engine import (
    Trainer, make_train_step)

CFG = CLIPConfig.tiny_test()


def train_config(**kw) -> TrainConfig:
    base = dict(clip_model="tiny", batch_size=8,
                gradient_accumulation_steps=2, lr=1e-3, use_amp=False,
                loss_type="clip", log_every=1000, warmup_steps=0)
    base.update(kw)
    if base["loss_type"] == "sparc":
        base.setdefault("inverse_temperature", 0.07)
    return TrainConfig(**base)


def make_batch(seed: int, loss_type: str, accum: int = 2, B: int = 8):
    """A global batch ``[accum, B, …]`` of numpy arrays; some captions end
    in padding (SPARC's mask, of unequal lengths across the ranks)."""
    rng = np.random.default_rng(seed)
    v, t = CFG.vision, CFG.text
    T = t.max_position_embeddings

    def ids(*lead):
        x = rng.integers(1, t.bos_token_id - 1,
                         size=lead + (T,)).astype(np.int32)
        x[..., -1] = t.eos_token_id
        return x

    input_ids = ids(accum, B)
    for j, cut in ((0, 5), (1, 9), (B - 1, 3)):   # rank 0 holds two
        input_ids[:, j, T - cut] = t.eos_token_id
        input_ids[:, j, T - cut + 1:] = t.pad_token_id
    batch = {"pixel_values": rng.normal(
        size=(accum, B, v.image_size, v.image_size, 3)).astype(np.float32),
        "input_ids": input_ids}
    if loss_type == "count":
        batch["cf_input_ids"] = ids(accum, B, 3)
    if loss_type == "clip_count":
        batch["group_input_ids"] = ids(accum, B, 2)
    return batch


def initial_state(seed: int):
    return state_dict_from_jax(random_params(CFG, seed), CFG)


def numpy_state(state) -> dict:
    """A trainer state (``{"model", "optimizer"}``) as numpy leaves."""
    def conv(x):
        if torch.is_tensor(x):
            return x.detach().cpu().numpy().copy()
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x
    return conv(state)


def optimizer_bytes(opt) -> int:
    """Bytes of optimizer-state tensors this rank holds."""
    return sum(t.numel() * t.element_size()
               for st in opt.optimizer.state.values()
               for t in st.values() if torch.is_tensor(t))


def _mesh(mesh_kw=None, cfg=None):
    """The group's mesh; with ``cfg`` its sequence-parallel flags too."""
    return pmesh.make_mesh(MeshConfig(**mesh_kw) if mesh_kw else None,
                           device=torch.device("cpu"),
                           sequence_parallel=bool(
                               cfg and cfg.sequence_parallel),
                           sp_ring=bool(cfg and cfg.sp_ring))


def anchors_off(seed: int) -> dict:
    """AdamSPD anchors 0.02 off the initial weights (normal, from a seed),
    so that −⟨g, p − pre⟩ and the projection ratio are well away from
    their thresholds on every tensor: a shard's partial sums then move
    the trajectory where the whole tensor's would not."""
    from clip_finegrained_alignment_tpu_torch.perf import \
        data_parallel_check as dpc
    return dpc.anchors_off(initial_state(seed), seed, scale=0.02)


def run_steps(cfg_kw: dict, seed: int, batch_seed: int, steps: int,
              modes=({},), anchors: bool = False):
    """For each mode (extra config fields), the step on the mesh
    (``make_optimizer`` and ``make_train_step``) from
    ``initial_state(seed)``, stepped ``steps`` times on this rank's rows of
    the same global batch: per step its metrics, then its whole state and
    the rank's optimizer bytes. ``anchors``: :func:`anchors_off`, else the
    initial weights."""
    mesh = _mesh()
    cfg0 = train_config(**cfg_kw)
    batch = pmesh.shard_batch(make_batch(batch_seed, cfg0.loss_type,
                                         cfg0.gradient_accumulation_steps,
                                         cfg0.batch_size),
                              mesh, accum_axis=True)
    out = []
    for mode in modes:
        cfg = train_config(**{**cfg_kw, **mode})
        model = tm.build_train_model(CFG, initial_state(seed), device="cpu")
        opt = make_optimizer(cfg, model.named_parameters(),
                             anchors=anchors_off(seed) if anchors else None,
                             mesh=mesh)
        step = make_train_step(cfg, CFG, model, opt, mesh=mesh)
        metrics = [{k: float(v) for k, v in step(batch).items()}
                   for _ in range(steps)]
        params = opt.layout.full_params() if opt.layout is not None \
            else dict(model.named_parameters())
        out.append({"metrics": metrics,
                    "state": numpy_state({"model": params,
                                          "optimizer": opt.state_dict()}),
                    "opt_bytes": optimizer_bytes(opt)})
    return out


def _rows_batches(mesh, cfg, seeds, hook=None):
    """``batches(epoch)`` for Trainer.train: this rank's rows of one global
    batch a seed, flattened to [accum·B/W, …] (what a rank's pipeline
    yields); ``hook(i)`` before each."""
    def batches(epoch):
        for i, s in enumerate(seeds[epoch]):
            if hook:
                hook(i)
            b = pmesh.shard_batch(make_batch(
                s, cfg.loss_type, cfg.gradient_accumulation_steps,
                cfg.batch_size), mesh, accum_axis=True)
            yield {k: x.reshape((-1,) + x.shape[2:]) for k, x in b.items()}
    return batches


def checkpoint_cases(cfg_kw: dict, ckpt_root: str, w1_dir: str,
                     mesh_kw=None):
    """Per layout in ``cfg_kw`` (a list of extra fields): an unbroken run
    of 2 epochs x 2 steps saving each epoch; a run restored from its
    ``epoch_0/`` trained on through epoch 1; a run preempted by rank 1
    alone after its first step; and the state a trainer restores from
    ``w1_dir`` (written by one process). ``mesh_kw``: the ``MeshConfig``
    fields (None: every rank a data rank)."""
    mesh = _mesh(mesh_kw)
    seeds = [[11, 12], [13, 14]]
    out = {}
    for name, extra in cfg_kw.items():
        cfg = train_config(optimizer_type="adamspd", global_negatives=True,
                           save_every=1,
                           mesh=MeshConfig(**mesh_kw) if mesh_kw
                           else MeshConfig(data=mesh.data), **extra)
        if cfg.sequence_parallel:
            mesh = _mesh(mesh_kw, cfg)
        d = os.path.join(ckpt_root, name)
        unbroken = Trainer(cfg, initial_state(5), device="cpu", mesh=mesh,
                           checkpoint_manager=CheckpointManager(
                               d, save_every=1))
        hist = unbroken.train(_rows_batches(mesh, cfg, seeds), 2,
                              log_fn=None)["history"]
        resumed = Trainer(cfg, initial_state(6), device="cpu", mesh=mesh,
                          checkpoint_manager=CheckpointManager(d + "_b"))
        state, meta = CheckpointManager(d).restore("epoch_0")
        resumed.load_state_dict(state)
        resumed.global_step = meta["global_step"]
        resumed.train(_rows_batches(mesh, cfg, seeds), 2, start_epoch=1,
                      log_fn=None)
        pre = Trainer(cfg, initial_state(5), device="cpu", mesh=mesh,
                      checkpoint_manager=CheckpointManager(d + "_p"))

        def hook(i, t=pre):
            if i == 1 and mesh.rank == 1:
                t.request_preempt()
        preempt = pre.train(_rows_batches(mesh, cfg, seeds, hook), 2,
                            log_fn=None)
        w1 = Trainer(cfg, initial_state(7), device="cpu", mesh=mesh)
        w1.load_state_dict(CheckpointManager(w1_dir).restore("best")[0])
        out[name] = {
            "losses": [h["avg_loss"] for h in hist],
            "unbroken": numpy_state(unbroken.state_dict()),
            "resumed": numpy_state(resumed.state_dict()),
            "resumed_step": resumed.global_step,
            "preempted": preempt["preempted"],
            "preempt_step": preempt["global_step"],
            "w1_restored": numpy_state(w1.state_dict())}
    return out


def gradcache_case(loss_type: str, seed: int):
    """One GradCache step with global negatives on this rank's rows."""
    mesh = _mesh()
    cfg = train_config(loss_type=loss_type, grad_cache=True,
                       global_negatives=True, optimizer_type="adamspd")
    batch = pmesh.shard_batch(make_batch(seed, loss_type), mesh,
                              accum_axis=True)
    t = Trainer(cfg, initial_state(seed), device="cpu", mesh=mesh)
    metrics = {k: float(v) for k, v in t.train_step(batch).items()}
    return {"metrics": metrics, "state": numpy_state(t.state_dict())}


def cli_main(module: str, argv):
    """``main(argv)`` of a port CLI on this rank (the group is up); of
    the training CLI with ``--eval-every-epoch`` also the rank's first
    batch of epoch 0 (what rank 0 holds out for the evaluation)."""
    import importlib
    os.environ["CFA_ALLOW_HASH_TOKENIZER"] = "1"
    result = importlib.import_module(module).main(argv)
    if module.endswith(".train"):
        t, pipe = result["trainer"], result["pipeline"]
        out = {"losses": [h["avg_loss"] for h in result["history"]],
               "global_step": t.global_step,
               "state": numpy_state(t.state_dict())}
        if "--eval-every-epoch" in argv:
            first = next(iter(pipe.epoch(0)))
            if "pixel_index" in first:
                first = pipe.materialize(first)
            out["first_batch"] = {k: np.asarray(v) for k, v in first.items()}
        return out
    return result


def cli_mains(module: str, argvs):
    """:func:`cli_main` for each of ``argvs`` in turn, on the same
    ranks."""
    return [cli_main(module, argv) for argv in argvs]


def phase_10_modes(shard_sums_alone: bool, *args):
    """``perf/data_parallel_check.py::rank_modes(*args)`` on this rank;
    with ``shard_sums_alone`` AdamSPD reads its shards' sums alone (no
    ``reduce_sums``), the fault phase 10's vs-replicated gate is for."""
    from clip_finegrained_alignment_tpu_torch.optim import adamspd
    from clip_finegrained_alignment_tpu_torch.perf import \
        data_parallel_check as dpc
    if shard_sums_alone:
        init = adamspd.AdamSPD.__init__

        def alone(self, *a, **kw):
            init(self, *a, **{**kw, "reduce_sums": None})
        adamspd.AdamSPD.__init__ = alone
    return dpc.rank_modes(*args)


def local_negatives_cases(cfg_kw: dict, seed: int, batch_seed: int,
                          modes, int8_kw: dict):
    """:func:`run_steps` of ``modes`` (one step each), then one step of
    local negatives with ``quant="int8"`` (``int8_kw``) twice: as the port
    runs it, counting the int8 products' collectives and split passes it
    makes, and through the projections as they were before the scales took
    groups (``quant_linear`` with the bare mode). Returns the run_steps
    results, both int8 runs and that count."""
    from clip_finegrained_alignment_tpu_torch.ops import quant as tq
    from clip_finegrained_alignment_tpu_torch.parallel import collectives
    out = run_steps(cfg_kw, seed, batch_seed, 1, modes)
    calls = []

    def spy(fn):
        def run(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return run
    kept = {n: getattr(tq, n) for n in tq.SPLIT_KERNELS}
    kept_c = (collectives.all_reduce_absmax, collectives.all_reduce_sum_)
    try:
        for n in tq.SPLIT_KERNELS:
            setattr(tq, n, spy(kept[n]))
        collectives.all_reduce_absmax = spy(kept_c[0])
        collectives.all_reduce_sum_ = spy(kept_c[1])
        now = run_steps(int8_kw, seed, batch_seed, 1)[0]
    finally:
        for n in tq.SPLIT_KERNELS:
            setattr(tq, n, kept[n])
        (collectives.all_reduce_absmax,
         collectives.all_reduce_sum_) = kept_c
    linear_fn = tm._linear_fn

    def before(quant, groups=None):
        if quant == "none":
            return tm.linear
        return lambda x, w, b, dtype: tq.quant_linear(x, w, b, dtype, quant)
    try:
        tm._linear_fn = before
        then = run_steps(int8_kw, seed, batch_seed, 1)[0]
    finally:
        tm._linear_fn = linear_fn
    return {"modes": out, "int8": now, "int8_before": then, "calls": calls}


def mp_steps(cases, seed: int, batch_seed: int, steps: int = 1):
    """For each ``(mesh_kw, cfg_kw)`` of ``cases`` (one rank count): the
    Trainer on that ``data × model × pipe`` mesh of this group, ``steps``
    steps on this rank's rows of one global batch: per step its metrics,
    the whole model after the first step, then the whole state it
    gathers, this rank's coordinates and its parameters' shapes."""
    out = []
    for mesh_kw, cfg_kw in cases:
        cfg = train_config(mesh=MeshConfig(**mesh_kw), **cfg_kw)
        mesh = _mesh(mesh_kw, cfg)
        batch = pmesh.shard_batch(make_batch(
            batch_seed, cfg.loss_type, cfg.gradient_accumulation_steps,
            cfg.batch_size), mesh, accum_axis=True)
        t = Trainer(cfg, initial_state(seed), device="cpu", mesh=mesh)
        metrics, first = [], None
        for s in range(steps):
            metrics.append({k: float(v)
                            for k, v in t.train_step(batch).items()})
            if s == 0:
                first = numpy_state(t.model_state())
        out.append({"metrics": metrics, "first": first,
                    "state": numpy_state(t.state_dict()),
                    "coords": (mesh.data_rank, mesh.model_rank,
                               mesh.pipe_rank),
                    "shapes": {n: tuple(p.shape)
                               for n, p in t.model.named_parameters()}})
    return out


def phase_11_gate_cases(cases, model_name, layers, B, accum, seed, steps):
    """For each ``(fault, modes, dtype)`` of ``cases``:
    ``perf/model_parallel_check.py::rank_modes`` of those modes in that
    dtype with ``fault`` on this rank, the port put back as it was after
    each."""
    from clip_finegrained_alignment_tpu_torch.parallel import sequence
    from clip_finegrained_alignment_tpu_torch.parallel.zero import \
        ShardLayout
    from clip_finegrained_alignment_tpu_torch.perf import \
        model_parallel_check as mpc
    from clip_finegrained_alignment_tpu_torch.train import engine
    kept = (engine.before_pipeline, engine.before_gather,
            sequence.gather_tokens, ShardLayout.reduce_sums,
            ShardLayout.grad_norm, tm._quantized)
    out = []
    for fault, modes, dtype in cases:
        try:
            out.append(mpc.rank_modes(model_name, layers, dtype, B, accum,
                                      seed, steps, modes, fault=fault))
        finally:
            (engine.before_pipeline, engine.before_gather,
             sequence.gather_tokens, ShardLayout.reduce_sums,
             ShardLayout.grad_norm, tm._quantized) = kept
    return out


def checkpoint_layouts(layouts, ckpt_root: str, w1_dir: str):
    """:func:`checkpoint_cases` for each ``(name, mesh_kw, extra)`` of
    ``layouts`` in turn, on the same ranks."""
    return {name: checkpoint_cases({name: extra},
                                   os.path.join(ckpt_root, name), w1_dir,
                                   mesh_kw)[name]
            for name, mesh_kw, extra in layouts}


def mp_group(steps_args, gate_args=None, checkpoint_args=None,
             pp_report_args=None):
    """One spawn's work in ``test_torch_model_parallel.py``:
    :func:`mp_steps` ``(*steps_args)``, then, where given,
    :func:`phase_11_gate_cases` ``(*gate_args)``,
    :func:`checkpoint_layouts` ``(*checkpoint_args)`` and
    ``perf/pp_activation_report.py::rank_report`` ``(*pp_report_args)`` on
    the same ranks."""
    from clip_finegrained_alignment_tpu_torch.perf import \
        pp_activation_report
    return {"steps": mp_steps(*steps_args),
            "gates": gate_args and phase_11_gate_cases(*gate_args),
            "checkpoints": checkpoint_args
            and checkpoint_layouts(*checkpoint_args),
            "pp_report": pp_report_args
            and pp_activation_report.rank_report(*pp_report_args)}
