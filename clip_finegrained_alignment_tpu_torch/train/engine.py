"""The train step and the epoch trainer, the port of
``clip_finegrained_alignment_tpu/train/engine.py``'s single-device path
(``compute_loss``, the microbatch accumulation, ``make_train_step`` with
``mesh=None``, ``Trainer`` and ``install_preemption_handler``).

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

Every encoder layer goes through ``ops/attention.py`` (forward and
backward kernels) and, under SPARC, the local term through
``ops/sparc_kernel.py``: on the card their CUDA kernels, on the CPU their
plain versions. With ``cfg.quant`` ``switchback`` or ``int8`` both
towers' encoder projections and the patch embedding, in every forward
the step runs (the count losses' extra text forwards too), take the
dynamic int8 GEMMs of ``ops/quant.py``.

Deliberate differences from the JAX package: with no state dict the
``Trainer`` starts from ``models/convert.py::random_params(cfg, seed)``
(numpy), not from ``jax.random``; its checkpoints are torch files (the
reference ``.pt`` format is the bridge between the packages); mesh, ZeRO,
FSDP and the unstacked layer layout wait for the multi-GPU slice, so the
checkpoint format is the model's and optimizer's own state dicts.
"""

from __future__ import annotations

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
                 pixel_bank: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and objective for one microbatch → (total loss, loss dict).

    ``batch``: pixel_values [B, H, W, 3] (normalized float, or uint8), or
    with ``pixel_bank`` pixel_index [B] (rows of the bank); input_ids
    [B, T]; cf_input_ids [B, N_cf, T] for ``count``; optional
    group_input_ids [B, G, T] for ``clip_count``."""
    input_ids = batch["input_ids"]
    out = m.clip_forward(model, device_pixels(batch, pixel_bank), input_ids,
                         dtype=dtype, quant=cfg.quant)

    if cfg.loss_type == "sparc":
        v_patch, l_token = m.sparc_embeddings(model, out, dtype=dtype)
        mask = input_ids != model_cfg.text.pad_token_id
        losses = L.sparc_loss(
            v_patch, l_token, mask,
            similarity_threshold=cfg.similarity_threshold,
            global_loss_weight=cfg.global_loss_weight,
            local_loss_weight=cfg.local_loss_weight,
            inverse_temperature=cfg.inverse_temperature)
    elif cfg.loss_type == "count":
        cf = batch["cf_input_ids"]
        B, N, T = cf.shape
        ek_cf = m.encode_text(model, cf.reshape(B * N, T), dtype=dtype,
                              quant=cfg.quant).reshape(B, N, -1)
        losses = L.count_loss(out.logits_per_image, out.logits_per_text,
                              out.image_embeds, out.text_embeds, ek_cf,
                              alpha=cfg.count_alpha)
    elif cfg.loss_type == "clip_count":
        group = batch.get("group_input_ids")
        ek = None
        if group is not None:
            B, G, T = group.shape
            ek = m.encode_text(model, group.reshape(B * G, T), dtype=dtype,
                               quant=cfg.quant).reshape(B, G, -1)
        losses = L.clip_count_loss(out.image_embeds, out.text_embeds, ek,
                                   count_alpha=cfg.count_alpha)
    else:  # "clip"
        losses = L.clip_loss(out.image_embeds, out.text_embeds)
    return losses["total_loss"], losses


def accumulate_grads(model: m.CLIPModel, batch: Batch, cfg: TrainConfig,
                     model_cfg: CLIPConfig, *, dtype,
                     pixel_bank: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Forward and backward over each microbatch of ``batch`` (leaves
    ``[accum, B, …]`` on the model's device); leaves the mean gradient in
    ``.grad`` and returns the mean loss dict (detached)."""
    model.zero_grad(set_to_none=True)
    accum = batch["input_ids"].shape[0]
    totals: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        loss, losses = compute_loss(model, {k: x[i] for k, x in batch.items()},
                                    cfg, model_cfg, dtype=dtype,
                                    pixel_bank=pixel_bank)
        loss.backward()
        for k, x in losses.items():
            totals[k] = totals[k] + x.detach() if k in totals else x.detach()
    inv = 1.0 / accum
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
    return {k: x * inv for k, x in totals.items()}


def make_train_step(cfg: TrainConfig, model_cfg: CLIPConfig,
                    model: m.CLIPModel, optimizer: ClippedOptimizer,
                    pixel_bank: Optional[torch.Tensor] = None) -> Callable:
    """``train_step(batch) -> metrics``: ``batch`` leaves are
    ``[accum, B, …]`` (tensors or numpy arrays, moved to the model's
    device); ``metrics`` holds the mean losses (with ``grad_cache``: the
    full-pool losses) and ``grad_norm``, the global norm of the gradient
    before clipping, as 0-dim tensors on the device (reading them waits
    for the step).

    ``pixel_bank``: a uint8 ``[N, S, S, 3]`` tensor on the model's device
    (``place_pixel_bank``). Batches then carry ``pixel_index [accum, B]``
    in place of ``pixel_values``, and a step's host-to-device traffic
    drops from S·S·3 to 4 bytes a sample."""
    dtype = compute_dtype(cfg)
    device = next(model.parameters()).device
    if pixel_bank is not None and pixel_bank.device != device:
        raise ValueError(f"pixel bank on {pixel_bank.device}, model on "
                         f"{device}")
    grads = accumulate_grads
    if cfg.grad_cache:
        # One loss over the whole accum x B pool (train/gradcache.py) in
        # place of the mean of the microbatches' losses.
        from .gradcache import gradcache_grads, validate_gradcache
        validate_gradcache(cfg)
        grads = gradcache_grads

    def train_step(batch) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(x).to(device, non_blocking=True)
                 for k, x in batch.items()}
        metrics = grads(model, batch, cfg, model_cfg, dtype=dtype,
                        pixel_bank=pixel_bank)
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
                 device="cuda", checkpoint_manager=None, pixel_bank=None):
        """``state_dict``: HF-named weights (``models/convert.py``); None
        draws ``random_params(model_cfg, cfg.seed)``. AdamSPD anchors are
        the weights at construction. ``device`` is the card unless the
        caller asks for the CPU; ``pixel_bank`` (uint8 ``[N, S, S, 3]``,
        numpy or torch) is placed on it once."""
        self.cfg = cfg
        self.model_cfg = cfg.model_config()
        if state_dict is None:
            state_dict = convert.state_dict_from_jax(
                convert.random_params(self.model_cfg, cfg.seed),
                self.model_cfg)
        self.model = m.build_train_model(self.model_cfg, state_dict,
                                         device=device)
        self.device = next(self.model.parameters()).device
        self.optimizer = make_optimizer(cfg, self.model.named_parameters())
        self.pixel_bank = None if pixel_bank is None \
            else place_pixel_bank(pixel_bank, self.device)
        self.train_step = make_train_step(cfg, self.model_cfg, self.model,
                                          self.optimizer, self.pixel_bank)
        self.global_step = 0
        self.best_loss = float("inf")
        self.preempt_requested = False
        self.checkpoint_manager = checkpoint_manager

    def _device_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """Host batch [accum·B, …] → [accum, B, …]."""
        a = self.cfg.gradient_accumulation_steps

        def fold(x):
            x = np.asarray(x)
            return x.reshape((a, x.shape[0] // a) + x.shape[1:])

        return {k: fold(v) for k, v in batch.items()}

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the model's and the optimizer's state."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
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
                if self.preempt_requested:
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
