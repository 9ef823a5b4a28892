"""The train step and the epoch trainer, the port of
``clip_finegrained_alignment_tpu/train/engine.py`` (``compute_loss``, the
microbatch accumulation, ``make_train_step``, ``Trainer`` and
``install_preemption_handler``), on one GPU or data-parallel over several
(one process a GPU, ``parallel/``).

* ``compute_loss`` dispatches the four objectives; the count loss encodes
  the counterfactual captions as one batched ``[B·N_cf, T]`` text forward,
  and uint8 pixels are rescaled and normalized on the device. With a pixel
  bank (a uint8 ``[N, S, S, 3]`` tensor on the device) the batch carries
  ``pixel_index`` and the pixels are gathered from the bank on the device.
* The step runs a forward and a backward per microbatch of the
  ``[accum, B, …]`` batch; ``.grad`` sums the microbatch gradients and is
  scaled by 1/accum at the end, which is the JAX package's order
  (sum, then scale). With ``grad_cache`` it takes
  ``train/gradcache.py::gradcache_grads`` instead: one loss over the
  whole ``accum·B`` pool.
* Then ``grad_norm`` (before clipping), the global-norm clip and the
  optimizer step (``optim/factory.py``). Towers run in the compute dtype
  (bf16 by default) on fp32 master parameters; losses and the optimizer
  run in fp32.

* ``Trainer`` runs epochs of host batches ``[accum·B, …]`` folded into
  ``[accum, B, …]``: the epoch loss is summed on the device and read only
  at ``log_every``, at preemption and at the epoch's end; best and periodic
  checkpoints go through ``train/checkpoint.py``; ``request_preempt``
  (SIGTERM through ``install_preemption_handler``) saves ``preempt/`` at
  the next step boundary.

Data parallelism (``mesh``: ``parallel/mesh.py::Mesh``; each rank feeds
its data coordinate's rows ``[accum, B/D, …]``, D data ranks):

* **Local negatives** (the default; the reference's DDP): each rank's
  loss sees its own rows; it accumulates its microbatches with no
  collective, then one all-reduce (mean) of all gradients through one flat
  fp32 buffer and one of the losses, then the clip and the optimizer.
* **Global negatives** (``cfg.global_negatives``): inside each
  microbatch's loss the contrastive terms' embeddings are gathered over
  the ranks by a gather whose backward sums over them, so every rank
  computes the global batch's loss; after the same mean all-reduce the
  gradient is that loss's exactly (the gather's backward hands each rank
  W times its rows' share, the mean divides by W).
* **ZeRO-1 / FSDP** (``cfg.zero1`` / ``cfg.fsdp``, ``parallel/zero.py``):
  the optimizer steps this rank's shards; under FSDP the step gathers the
  parameters before the forward and reduce-scatters the gradients after
  the backward in place of the all-reduce.

Tensor and pipeline parallelism (a mesh with ``model`` or ``pipe`` above
1, global negatives only, as in JAX): the model holds this rank's
tensor-parallel shards and pipeline stage (``models/clip.py``,
``parallel/pipeline.py``); ranks that share a data coordinate feed the
same rows. After the microbatches the embeddings' gradients (stage 0's
alone) are summed over the pipe group; every other whole parameter's
gradient is already the same on every model rank and stage and is not
reduced there. Then the data reduction above, over the data group. The
norm and AdamSPD's sums count every tensor once
(``parallel/zero.py::ShardLayout.reduce_rows``).

Sequence parallelism (``cfg.sequence_parallel`` on a mesh with ``model``
above 1, global negatives only, no pipeline, as in JAX;
``parallel/sequence.py``): the model axis splits the encoders' tokens and
the parameters are whole on every model rank. Every forward the step runs
(the count loss's counterfactual ``[B·N, T]`` text forward too) takes the
``seq`` spec; GSPMD SP or, with ``cfg.sp_ring``, ring attention. After the
microbatches the gradients of the parameters used before the towers'
gather (``sharding_rules.before_gather``) are summed over the model group
(each rank's is its tokens' part); the others are already whole. Then the
data reduction, the norm and AdamSPD's sums as above.

The model is not wrapped in ``DistributedDataParallel``: its hooks reduce
bucket by bucket during every backward (accumulation would need
``no_sync``), and its ``module.`` prefix would change the checkpoint keys.

Every encoder layer goes through ``ops/attention.py`` (forward and
backward kernels) and, under SPARC, the local term through
``ops/sparc_kernel.py``: on the card their CUDA kernels, on the CPU their
plain versions. With ``cfg.quant`` ``switchback`` or ``int8`` both
towers' encoder projections and the patch embedding, in every forward
the step runs (the count losses' extra text forwards too), take the
dynamic int8 GEMMs of ``ops/quant.py``. Every scale is the one JAX's
GSPMD step takes: under tensor parallelism the TP layers take theirs over
the model group; under global negatives the int8 wgrad's scales reduce
over the microbatch's rows on every data rank, and under sequence
parallelism over every rank's token block too: the model holds those
groups (``models/clip.py::build_train_model(..., mesh=,
global_negatives=True)``, ``parallel/mesh.py::Mesh.rows_group``). Local
negatives take none (JAX's per-rank ``shard_map``).

Deliberate differences from the JAX package: with no state dict the
``Trainer`` starts from ``models/convert.py::random_params(cfg, seed)``
(numpy), not from ``jax.random``; its checkpoints are torch files (the
reference ``.pt`` format is the bridge between the packages), written
whole by rank 0 in the replicated format under every layout, and loaded
into any layout.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import CLIPConfig, TrainConfig
from ..core.precision import compute_dtype
from ..data.preprocess import normalize_batch
from ..models import clip as m
from ..models import convert
from ..objectives import losses as L
from ..optim.factory import ClippedOptimizer, make_optimizer
from ..parallel import collectives as C
from ..parallel.mesh import Mesh, replicate, shard_batch_from_local
from ..parallel.sequence import SeqParallelSpec
from ..parallel.sharding_rules import before_gather, before_pipeline
from ..utils.logging import span

Batch = Mapping[str, torch.Tensor]


def device_pixels(batch: Batch,
                  pixel_bank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The microbatch's normalized pixels: ``pixel_values``, or with
    ``pixel_bank`` the bank's rows at ``pixel_index``; uint8 is rescaled
    and normalized on the device."""
    if pixel_bank is not None:
        pixel_values = pixel_bank[batch["pixel_index"].long()]
    else:
        pixel_values = batch["pixel_values"]
    if pixel_values.dtype == torch.uint8:
        pixel_values = normalize_batch(pixel_values.float() / 255.0)
    return pixel_values


def compute_loss(model: m.CLIPModel, batch: Batch, cfg: TrainConfig,
                 model_cfg: CLIPConfig, *, dtype,
                 pixel_bank: Optional[torch.Tensor] = None,
                 mesh: Optional[Mesh] = None,
                 seq: Optional[SeqParallelSpec] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and objective for one microbatch → (total loss, loss dict).

    ``batch``: pixel_values [B, H, W, 3] (normalized float, or uint8), or
    with ``pixel_bank`` pixel_index [B] (rows of the bank); input_ids
    [B, T]; cf_input_ids [B, N_cf, T] for ``count``; optional
    group_input_ids [B, G, T] for ``clip_count``. ``mesh``: global
    negatives: every embedding of an in-batch contrastive term is gathered
    over the data ranks (SPARC's pooled ones, in ``sparc_loss``). ``seq``:
    every forward runs sequence-parallel (``parallel/sequence.py``)."""
    input_ids = batch["input_ids"]
    out = m.clip_forward(model, device_pixels(batch, pixel_bank), input_ids,
                         dtype=dtype, quant=cfg.quant, seq=seq)

    if cfg.loss_type == "sparc":
        v_patch, l_token = m.sparc_embeddings(model, out, dtype=dtype)
        mask = input_ids != model_cfg.text.pad_token_id
        losses = L.sparc_loss(
            v_patch, l_token, mask,
            similarity_threshold=cfg.similarity_threshold,
            global_loss_weight=cfg.global_loss_weight,
            local_loss_weight=cfg.local_loss_weight,
            inverse_temperature=cfg.inverse_temperature, mesh=mesh)
        return losses["total_loss"], losses

    ie, te = out.image_embeds, out.text_embeds
    if mesh is not None:
        ie, te = mesh.gather(ie), mesh.gather(te)
    if cfg.loss_type == "count":
        cf = batch["cf_input_ids"]
        B, N, T = cf.shape
        ek_cf = m.encode_text(model, cf.reshape(B * N, T), dtype=dtype,
                              quant=cfg.quant, seq=seq).reshape(B, N, -1)
        logits_per_text = out.logits_per_text if mesh is None \
            else m.clip_logits(model, ie, te)
        if mesh is not None:
            ek_cf = mesh.gather(ek_cf)
        losses = L.count_loss(logits_per_text.t(), logits_per_text, ie, te,
                              ek_cf, alpha=cfg.count_alpha)
    elif cfg.loss_type == "clip_count":
        group = batch.get("group_input_ids")
        ek = None
        if group is not None:
            B, G, T = group.shape
            ek = m.encode_text(model, group.reshape(B * G, T), dtype=dtype,
                               quant=cfg.quant, seq=seq).reshape(B, G, -1)
            if mesh is not None:
                ek = mesh.gather(ek)
        losses = L.clip_count_loss(ie, te, ek, count_alpha=cfg.count_alpha)
    else:  # "clip"
        losses = L.clip_loss(ie, te)
    return losses["total_loss"], losses


def accumulate_grads(model: m.CLIPModel, batch: Batch, cfg: TrainConfig,
                     model_cfg: CLIPConfig, *, dtype,
                     pixel_bank: Optional[torch.Tensor] = None,
                     mesh: Optional[Mesh] = None,
                     seq: Optional[SeqParallelSpec] = None
                     ) -> Dict[str, torch.Tensor]:
    """Forward and backward over each microbatch of ``batch`` (leaves
    ``[accum, B, …]`` on the model's device); leaves the mean gradient in
    ``.grad`` and returns the mean loss dict (detached). ``mesh``: global
    negatives; ``seq``: sequence parallelism (:func:`compute_loss`)."""
    model.zero_grad(set_to_none=True)
    accum = batch["input_ids"].shape[0]
    totals: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        with span("train.forward", micro=i):
            loss, losses = compute_loss(
                model, {k: x[i] for k, x in batch.items()}, cfg, model_cfg,
                dtype=dtype, pixel_bank=pixel_bank, mesh=mesh, seq=seq)
        with span("train.backward", micro=i):
            loss.backward()
            if model.pipeline is not None:   # the stages' backward schedule
                model.pipeline.backward()
        for k, x in losses.items():
            totals[k] = totals[k] + x.detach() if k in totals else x.detach()
    inv = 1.0 / accum
    with span("train.grad_mean"), torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
    return {k: x * inv for k, x in totals.items()}


def sequence_parallel(cfg: TrainConfig) -> bool:
    """Whether ``cfg`` runs sequence-parallel: ``sequence_parallel`` on a
    mesh of more than one rank (on one, as in JAX, the step is the
    ordinary one)."""
    mc = cfg.mesh
    return cfg.sequence_parallel and mc.data * mc.model * mc.pipe > 1


def check_parallel(cfg: TrainConfig) -> None:
    """Refuse the layouts the step cannot build, with the JAX package's
    words where it refuses them too (tensor, pipeline or sequence
    parallelism without global negatives, sequence parallelism without a
    model axis or with a pipeline, FSDP without global negatives, FSDP
    with ZeRO-1, shapes the model or pipe axis does not divide)."""
    if cfg.mesh.pipe > 1 and not cfg.global_negatives:
        raise ValueError("pipeline parallelism (mesh.pipe > 1) requires "
                         "global_negatives=True: the DDP-parity shard_map "
                         "path assumes replicated params")
    sp = sequence_parallel(cfg)
    if sp:
        if cfg.mesh.model <= 1:
            raise ValueError(
                "sequence_parallel needs mesh.model > 1 (the model axis "
                "is the sequence axis)")
        if not cfg.global_negatives:
            raise ValueError(
                "sequence parallelism requires global_negatives=True: "
                "the DDP-parity shard_map path assumes replicated "
                "single-device math")
        if cfg.mesh.pipe > 1:
            raise ValueError("sequence parallelism composed with pipeline "
                             "parallelism is not supported")
    tp = cfg.mesh.model > 1 and not sp
    if tp and not cfg.global_negatives:
        raise ValueError("tensor parallelism (mesh.model > 1) requires "
                         "global_negatives=True: the DDP-parity shard_map "
                         "path assumes replicated params")
    if cfg.fsdp and not cfg.global_negatives:
        raise ValueError("fsdp requires global_negatives=True: the "
                         "local-negatives (DDP) step assumes replicated "
                         "params")
    if cfg.fsdp and cfg.zero1:
        raise ValueError("fsdp subsumes zero1 (optimizer state inherits the "
                         "data-sharded param layout); enable only one")
    if tp or cfg.mesh.pipe > 1:
        from ..parallel.pipeline import validate_pipe_divisibility
        from ..parallel.sharding_rules import validate_tp_divisibility
        model_cfg = cfg.model_config()
        with torch.device("meta"):
            whole = m.CLIPModel(model_cfg)
        validate_tp_divisibility(
            {n: tuple(p.shape) for n, p in whole.named_parameters()},
            cfg.mesh.model if tp else 1,
            {"vision": model_cfg.vision.num_heads,
                             "text": model_cfg.text.num_heads})
        validate_pipe_divisibility(model_cfg, cfg.mesh,
                                   cfg.batch_size // max(1, cfg.mesh.data),
                                   cfg.pipeline_microbatches)


def make_train_step(cfg: TrainConfig, model_cfg: CLIPConfig,
                    model: m.CLIPModel, optimizer: ClippedOptimizer,
                    pixel_bank: Optional[torch.Tensor] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``train_step(batch) -> metrics``: ``batch`` leaves are
    ``[accum, B, …]`` (tensors or numpy arrays, moved to the model's
    device); ``metrics`` holds the mean losses (with ``grad_cache``: the
    full-pool losses) and ``grad_norm``, the global norm of the gradient
    before clipping, as 0-dim tensors on the device (reading them waits
    for the step).

    ``pixel_bank``: a uint8 ``[N, S, S, 3]`` tensor on the model's device
    (``place_pixel_bank``). Batches then carry ``pixel_index [accum, B]``
    in place of ``pixel_values``, and a step's host-to-device traffic
    drops from S·S·3 to 4 bytes a sample.

    ``mesh``: data parallelism; ``batch`` holds this rank's rows
    ``[accum, B/D, …]`` (``parallel/mesh.py::shard_batch``), the metrics
    are the means over the data ranks. With ``cfg.zero1`` or ``cfg.fsdp``
    the optimizer must have been built with ``make_optimizer(...,
    mesh=…)``; with ``mesh.model`` or ``mesh.pipe`` above 1, or with
    ``int8`` under global negatives, the model too
    (``build_train_model(..., mesh=…, global_negatives=…)``); with
    ``cfg.sequence_parallel`` the mesh is ``make_mesh(...,
    sequence_parallel=True, sp_ring=…)``."""
    check_parallel(cfg)
    tp_pp = mesh is not None and (mesh.model > 1 or mesh.pipe > 1)
    if (cfg.mesh.model, cfg.mesh.pipe) != ((mesh.model, mesh.pipe)
                                           if mesh is not None else (1, 1)):
        raise ValueError(f"config mesh model={cfg.mesh.model} "
                         f"pipe={cfg.mesh.pipe} but the step's mesh is "
                         f"{mesh}")
    sp = sequence_parallel(cfg) and mesh is not None
    if mesh is not None and mesh.model > 1 and (
            mesh.sequence_parallel != sp
            or (sp and cfg.sp_ring and "ring_next" not in mesh.groups)):
        raise ValueError("sequence parallelism: build the mesh with "
                         "make_mesh(cfg.mesh, sequence_parallel="
                         "cfg.sequence_parallel, sp_ring=cfg.sp_ring)")
    if tp_pp and optimizer.layout is None:
        raise ValueError("tensor, pipeline or sequence parallelism: build "
                         "the optimizer with make_optimizer(cfg, ..., "
                         "mesh=mesh)")
    if (mesh is not None and mesh.pipe > 1) != (model.pipeline is not None):
        raise ValueError("pipeline parallelism: build the model with "
                         "build_train_model(..., mesh=mesh)")
    if cfg.quant == "int8" and (model.rows is not None) != (
            mesh is not None and cfg.global_negatives
            and mesh.rows_group() is not None):
        raise ValueError("int8 on a mesh: build the model with "
                         "build_train_model(..., mesh=mesh, "
                         "global_negatives=cfg.global_negatives)")
    dtype = compute_dtype(cfg)
    device = next(model.parameters()).device
    if pixel_bank is not None and pixel_bank.device != device:
        raise ValueError(f"pixel bank on {pixel_bank.device}, model on "
                         f"{device}")
    layout = optimizer.layout
    if mesh is not None and (cfg.zero1 or cfg.fsdp) and (
            layout is None or layout.fsdp != cfg.fsdp):
        raise ValueError("zero1/fsdp on a mesh: build the optimizer with "
                         "make_optimizer(cfg, ..., mesh=mesh)")
    grads = accumulate_grads
    if cfg.grad_cache:
        # One loss over the whole accum x B pool (train/gradcache.py) in
        # place of the mean of the microbatches' losses.
        from .gradcache import gradcache_grads, validate_gradcache
        validate_gradcache(cfg, mesh)
        grads = gradcache_grads
    extra = {}
    if sp:
        extra["seq"] = SeqParallelSpec(mesh, ring=cfg.sp_ring)
    loss_mesh = mesh if cfg.global_negatives else None
    fsdp = layout is not None and layout.fsdp
    params = list(model.parameters())
    # Under a pipeline the embeddings' gradients live on stage 0 alone.
    first_stage = [p for n, p in model.named_parameters()
                   if before_pipeline(n)] \
        if mesh is not None and mesh.pipe > 1 else []
    # Under sequence parallelism each model rank holds its tokens' part of
    # these (the gradient rule of parallel/sequence.py).
    pre_gather = [p for n, p in model.named_parameters()
                  if before_gather(n)] if sp else []

    steps = itertools.count()

    def train_step(batch) -> Dict[str, torch.Tensor]:
        with span("train.step", n=next(steps)):
            return _step(batch)

    def _step(batch) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(x).to(device, non_blocking=True)
                 for k, x in batch.items()}
        if fsdp:
            layout.gather_params()
        metrics = grads(model, batch, cfg, model_cfg, dtype=dtype,
                        pixel_bank=pixel_bank, mesh=loss_mesh, **extra)
        if mesh is not None:
            # The DDP all-reduce (mean) of the gradients, or under FSDP
            # their reduce-scatter into the shards; then the losses'.
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if first_stage:
                C.all_reduce_mean_([p.grad for p in first_stage],
                                   mesh.group("pipe"), mean=False)
            if pre_gather:
                C.all_reduce_mean_([p.grad for p in pre_gather],
                                   mesh.group("model"), mean=False)
            if fsdp:
                layout.reduce_grads()
            else:
                C.all_reduce_mean_([p.grad for p in params],
                                   mesh.group("data"))
            C.all_reduce_mean_(list(metrics.values()), mesh.group("data"))
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return train_step


def place_pixel_bank(bank, device, chunk: int = 1024) -> torch.Tensor:
    """A uint8 ``[N, S, S, 3]`` array (e.g. a packed dataset's memory-mapped
    ``pixels.npy``) copied to ``device`` once, ``chunk`` rows at a time, so
    the host never holds a second whole copy."""
    if isinstance(bank, torch.Tensor):
        return bank.to(device)
    out = torch.empty(tuple(bank.shape), dtype=torch.uint8, device=device)
    for lo in range(0, len(bank), chunk):
        out[lo:lo + chunk].copy_(torch.from_numpy(
            np.array(bank[lo:lo + chunk], dtype=np.uint8)))
    return out


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class Trainer:
    """The epoch loop with best and periodic checkpoints, the port of the
    JAX package's single-device ``Trainer``."""

    def __init__(self, cfg: TrainConfig,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, *,
                 device="cuda", checkpoint_manager=None, pixel_bank=None,
                 mesh: Optional[Mesh] = None):
        """``state_dict``: HF-named weights (``models/convert.py``); None
        draws ``random_params(model_cfg, cfg.seed)``. AdamSPD anchors are
        the weights at construction. ``device`` is the card unless the
        caller asks for the CPU; ``pixel_bank`` (uint8 ``[N, S, S, 3]``,
        numpy or torch) is placed on it once, whole on every rank.
        ``mesh``: data, tensor, pipeline and sequence parallelism
        (``parallel/mesh.py``): each rank holds its part of the whole
        ``state_dict``, data rank 0's weights are broadcast over the data
        ranks, and every rank must call ``step``, ``train``,
        ``state_dict`` and ``load_state_dict`` alike (they run
        collectives)."""
        check_parallel(cfg)
        if (cfg.mesh.model > 1 or cfg.mesh.pipe > 1) and mesh is None:
            raise ValueError(f"mesh {cfg.mesh.data}x{cfg.mesh.model}x"
                             f"{cfg.mesh.pipe}: tensor, pipeline and "
                             "sequence parallelism need the process "
                             "group's mesh "
                             "(parallel/mesh.py::make_mesh)")
        self.cfg = cfg
        self.model_cfg = cfg.model_config()
        self.mesh = mesh
        if state_dict is None:
            state_dict = convert.state_dict_from_jax(
                convert.random_params(self.model_cfg, cfg.seed),
                self.model_cfg)
        self.model = m.build_train_model(
            self.model_cfg, state_dict, device=device, mesh=mesh,
            num_micro=cfg.pipeline_microbatches,
            global_negatives=cfg.global_negatives)
        self.device = next(self.model.parameters()).device
        if mesh is not None:
            replicate(self.model.state_dict(), mesh)
        self.optimizer = make_optimizer(cfg, self.model.named_parameters(),
                                        mesh=mesh)
        self.pixel_bank = None if pixel_bank is None \
            else place_pixel_bank(pixel_bank, self.device)
        self.train_step = make_train_step(cfg, self.model_cfg, self.model,
                                          self.optimizer, self.pixel_bank,
                                          mesh=mesh)
        self.global_step = 0
        self.best_loss = float("inf")
        self.preempt_requested = False
        self.checkpoint_manager = checkpoint_manager

    def _device_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """Host batch [accum·B, …] → [accum, B, …]. Under a mesh the batch
        is this rank's (its pipeline reads its data coordinate's shard of
        the data at ``effective_batch_size / D``): B must be
        ``batch_size / D``."""
        a = self.cfg.gradient_accumulation_steps

        def fold(x):
            x = np.asarray(x)
            return x.reshape((a, x.shape[0] // a) + x.shape[1:])

        batch = {k: fold(v) for k, v in batch.items()}
        if self.mesh is None:
            return batch
        return shard_batch_from_local(
            batch, self.mesh, accum_axis=True,
            rows=self.cfg.batch_size // self.mesh.data)

    def model_state(self) -> Dict[str, torch.Tensor]:
        """The model's parameters by HF name, whole tensors under any
        layout (gathered: every rank calls it)."""
        layout = self.optimizer.layout
        model = self.model.state_dict()
        if layout is not None and layout.fsdp:
            model.update(layout.full_params())
        if layout is not None and layout.model_parallel:
            whole = layout.whole_tensors([[model[n]] for n in layout.names])
            model = {n: t[0] for n, t in zip(layout.whole, whole)}
        return model

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the model's and the optimizer's state,
        whole tensors under any layout (gathered: every rank calls it)."""
        return {"model": self.model_state(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Restore a :meth:`state_dict` of any rank count into this rank's
        layout."""
        layout = self.optimizer.layout
        if layout is not None and (layout.fsdp or layout.model_parallel):
            layout.load_params(state["model"])
        else:
            self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])

    def step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step on one [accum·B] host batch."""
        metrics = self.train_step(self._device_batch(batch))
        self.global_step += 1
        return metrics

    def request_preempt(self) -> None:
        """Ask the training loop to stop at the next step boundary and
        write an emergency checkpoint (sets a flag, so a signal handler may
        call it): ``train`` finishes the step in flight, saves
        ``<ckpt>/preempt`` and returns with ``preempted=True``."""
        self.preempt_requested = True

    def _preempt_agreed(self) -> bool:
        """Whether to stop at this step boundary: under a mesh, the flag
        all-reduced with MAX, so that a request on any rank stops every
        rank at the same step (one leaving alone would hang the others in
        their next collective)."""
        if self.mesh is not None:
            self.preempt_requested = C.all_reduce_max_flag(
                self.preempt_requested, self.mesh.device)
        return self.preempt_requested

    def _save_preempt(self, epoch: int, avg_loss: float) -> None:
        if self.checkpoint_manager is None:
            return
        self.checkpoint_manager.save_preempt(
            epoch=epoch, state=self.state_dict(),
            global_step=self.global_step, best_loss=self.best_loss,
            avg_loss=avg_loss, config=self.cfg)

    def train(self, batches: Callable[[int], Iterable[Mapping[str, Any]]],
              num_epochs: int, start_epoch: int = 0,
              log_fn: Optional[Callable[[str], None]] = print
              ) -> Dict[str, Any]:
        """``batches(epoch)`` yields host batches of
        ``effective_batch_size``. ``best`` is saved on a new best epoch
        loss and ``epoch_{n}`` every ``save_every`` epochs; a pending
        ``request_preempt`` is honoured at the next step boundary (the CLI
        resumes step-exact by skipping the interrupted epoch's completed
        steps)."""
        history = []
        for epoch in range(start_epoch, num_epochs):
            t0 = time.perf_counter()
            # The epoch's loss total stays on the device: reading it every
            # step would make the host wait for each step before it
            # enqueues the next.
            total, count = None, 0
            for batch in batches(epoch):
                metrics = self.step(batch)
                loss = metrics["total_loss"]
                total = loss if total is None else total + loss
                count += 1
                if log_fn and count % max(1, self.cfg.log_every) == 0:
                    log_fn(f"epoch {epoch} step {self.global_step} "
                           f"loss {metrics['total_loss'].item():.4f} "
                           f"gnorm {metrics['grad_norm'].item():.3f}")
                if self._preempt_agreed():
                    avg = total.item() / count
                    self._save_preempt(epoch, avg)
                    if log_fn:
                        log_fn(f"preempted at epoch {epoch} step "
                               f"{self.global_step}: emergency "
                               f"checkpoint saved")
                    return {"history": history,
                            "best_loss": self.best_loss,
                            "global_step": self.global_step,
                            "preempted": True}
            avg = total.item() / count if count else 0.0
            dt = time.perf_counter() - t0
            pairs = count * self.cfg.effective_batch_size
            history.append({"epoch": epoch, "avg_loss": avg,
                            "seconds": dt,
                            "pairs_per_sec": pairs / dt if dt > 0 else 0.0})
            if log_fn:
                log_fn(f"epoch {epoch} avg_loss {avg:.4f} "
                       f"({pairs / dt:.1f} pairs/s)" if dt > 0 else
                       f"epoch {epoch} avg_loss {avg:.4f}")
            is_best = avg < self.best_loss
            if is_best:
                self.best_loss = avg
            if self.checkpoint_manager is not None:
                self.checkpoint_manager.save(
                    epoch=epoch, state=self.state_dict(),
                    global_step=self.global_step, best_loss=self.best_loss,
                    avg_loss=avg, is_best=is_best, config=self.cfg)
        return {"history": history, "best_loss": self.best_loss,
                "global_step": self.global_step, "preempted": False}


def install_preemption_handler(trainer: Trainer, signals=None) -> dict:
    """Route SIGTERM (a cluster's preemption signal) to
    ``trainer.request_preempt()``, so a preempted run checkpoints and
    returns instead of dying mid-step. A handler installed before is
    called after. Main thread only (CPython's rule for signals). Returns
    the handlers it replaced, by signal, for the caller to put back once
    the run is over (the handler holds the trainer)."""
    import signal as _signal
    if signals is None:
        signals = (_signal.SIGTERM,)
    replaced = {}
    for sig in signals:
        prev = replaced[sig] = _signal.getsignal(sig)

        def handler(signum, frame, _prev=prev):
            trainer.request_preempt()
            if callable(_prev) and _prev not in (
                    _signal.SIG_IGN, _signal.SIG_DFL):
                _prev(signum, frame)

        _signal.signal(sig, handler)
    return replaced
