"""Checkpoints: the model's and the optimizer's state, the step and the
config, with the policy of ``clip_finegrained_alignment_tpu/train/
checkpoint.py::CheckpointManager``.

Layout::

    <dir>/best/          the latest best-loss checkpoint
    <dir>/epoch_<n>/     periodic snapshots, the newest ``keep_periodic``
    <dir>/preempt/       the emergency save of a preempted run

Each holds ``state.pt`` (``torch.save`` of ``{"model": ..., "optimizer":
...}``, read back with ``weights_only=True``) and ``meta.json`` with the
JAX package's keys: ``epoch``, ``global_step``, ``best_loss``,
``avg_loss``, ``preempted``, ``config``. Each file is written to a
temporary name and renamed, so a reader never sees half a file. When one
save goes to ``best/`` and ``epoch_<n>/`` both, the second ``state.pt`` is
a hard link of the first (a copy where links fail). ``restore`` warns on
config drift, as the JAX package does.

Under data parallelism every rank calls ``save`` with the whole state
(``Trainer.state_dict`` gathers it); rank 0 alone writes and prunes, then
every rank waits at a barrier, so that none reads or resumes a checkpoint
half written. ``restore`` reads on every rank; the state is whole, so it
loads at any rank count and under any layout (``meta.json``'s config
carries ``mesh``, ``global_negatives``, ``zero1`` and ``fsdp``).

Deliberate difference: torch files, not orbax (and no orbax-layout
migration). The bridge between the two packages is the reference ``.pt``
format (``models/convert.py::save_reference_checkpoint``).
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from ..config import TrainConfig
from ..parallel.mesh import rank, world_size

STATE_NAME = "state.pt"
META_NAME = "meta.json"


def _replace_from_tmp(path: str, write) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class CheckpointManager:
    """best / periodic / preempt checkpoint policy over torch files."""

    def __init__(self, directory: str, save_every: int = 5,
                 keep_periodic: int = 3):
        self.directory = os.path.abspath(directory)
        self.save_every = max(1, save_every)
        self.keep_periodic = keep_periodic
        os.makedirs(self.directory, exist_ok=True)

    def _save_to(self, names: List[str], state: Mapping[str, Any],
                 meta: Dict[str, Any]) -> None:
        if rank() == 0:
            self._write(names, state, meta)
        if world_size() > 1:
            import torch.distributed as dist
            dist.barrier()

    def _write(self, names: List[str], state: Mapping[str, Any],
               meta: Dict[str, Any]) -> None:
        first = None
        for name in names:
            path = os.path.join(self.directory, name)
            os.makedirs(path, exist_ok=True)
            target = os.path.join(path, STATE_NAME)
            if first is None:
                _replace_from_tmp(target, lambda t: torch.save(state, t))
                first = target
            else:
                def link(t, src=first):
                    try:
                        os.link(src, t)
                    except OSError:
                        shutil.copyfile(src, t)
                _replace_from_tmp(target, link)

            def write_meta(t):
                with open(t, "w") as f:
                    json.dump(meta, f, indent=2)
            _replace_from_tmp(os.path.join(path, META_NAME), write_meta)

    @staticmethod
    def _meta(epoch, global_step, best_loss, avg_loss, preempted,
              config: Optional[TrainConfig]) -> Dict[str, Any]:
        return {"epoch": epoch, "global_step": global_step,
                "best_loss": float(best_loss), "avg_loss": float(avg_loss),
                "preempted": preempted,
                "config": config.to_dict() if config is not None else None}

    def save(self, *, epoch: int, state: Mapping[str, Any],
             global_step: int, best_loss: float, avg_loss: float,
             is_best: bool, config: Optional[TrainConfig] = None) -> None:
        """``best/`` when ``is_best``; ``epoch_<epoch>/`` every
        ``save_every`` epochs, then the oldest beyond ``keep_periodic``
        are removed."""
        names = (["best"] if is_best else []) + (
            [f"epoch_{epoch}"] if (epoch + 1) % self.save_every == 0 else [])
        if not names:
            return
        self._save_to(names, state, self._meta(epoch, global_step, best_loss,
                                               avg_loss, False, config))
        if any(n.startswith("epoch_") for n in names) and rank() == 0:
            self._prune_periodic()

    def save_preempt(self, *, epoch: int, state: Mapping[str, Any],
                     global_step: int, best_loss: float, avg_loss: float,
                     config: Optional[TrainConfig] = None) -> None:
        """Emergency mid-epoch save to ``preempt/`` (the SIGTERM path,
        ``engine.install_preemption_handler``)."""
        self._save_to(["preempt"], state, self._meta(
            epoch, global_step, best_loss, avg_loss, True, config))

    def _epochs_on_disk(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("epoch_") and d.split("_", 1)[1].isdigit():
                out.append(int(d.split("_", 1)[1]))
        return sorted(out)

    def _prune_periodic(self) -> None:
        if self.keep_periodic <= 0:
            return
        for e in self._epochs_on_disk()[:-self.keep_periodic]:
            shutil.rmtree(os.path.join(self.directory, f"epoch_{e}"),
                          ignore_errors=True)

    def restore(self, which: str = "best", *,
                config: Optional[TrainConfig] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(state, meta)`` of ``<dir>/<which>``, the state's tensors on
        the CPU. Warns for every config field that differs from
        ``config``."""
        path = os.path.join(self.directory, which)
        state_path = os.path.join(path, STATE_NAME)
        if not os.path.exists(state_path):
            raise FileNotFoundError(f"no checkpoint at {path} "
                                    f"({STATE_NAME} missing)")
        meta_path = os.path.join(path, META_NAME)
        if not os.path.exists(meta_path):
            raise RuntimeError(
                f"checkpoint {path} has {STATE_NAME} but no {META_NAME}: "
                "resuming would silently reset global_step and best_loss")
        state = torch.load(state_path, map_location="cpu", weights_only=True)
        with open(meta_path) as f:
            meta = json.load(f)
        if config is not None and meta.get("config"):
            current = config.to_dict()
            for k, v in meta["config"].items():
                if k in current and current[k] != v:
                    warnings.warn(f"checkpoint config mismatch: {k} was "
                                  f"{v!r}, now {current[k]!r}")
        return state, meta

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs_on_disk()
        return max(epochs) if epochs else None
