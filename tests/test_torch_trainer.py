"""The port's ``Trainer`` and checkpoints (``train/engine.py``,
``train/checkpoint.py``, ``optim/factory.py``, the reference ``.pt``
export) against the JAX package's, on the CPU.

``CLIPConfig.tiny_test()`` in fp32, microbatch 4 × accum 2, lr 1e-3, on a
24-sample procedural fixture (generated at 64 px, fed at 32 px): the same
weights (``random_params`` through ``state_dict_from_jax``), the same
AdamSPD anchors (the weights at construction on both sides), the same
batches (each side's own pipeline; ``tests/test_torch_data.py`` holds
them byte-equal). The JAX side runs its Pallas kernels in interpret mode
(``use_pallas_attention``, ``use_fused_sparc``), as
``tests/test_torch_train.py`` does.

Tolerances: epoch losses rtol 2e-5 (fp32 on both sides, other summation
orders); each parameter's total update within 2e-3 of the largest update
of its tensor plus 1e-6, the update tolerance of
``tests/test_torch_train.py``. Runs of the port against runs of the port
(pixel bank against pixels, saved-then-resumed and preempted-then-resumed
against unbroken) are equal bit for bit.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_finegrained_alignment_tpu.config import \
    TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.data import datasets as jds
from clip_finegrained_alignment_tpu.data.tokenizer import \
    HashTokenizer as JHashTokenizer
from clip_finegrained_alignment_tpu.models import hf_import
from clip_finegrained_alignment_tpu.train.engine import Trainer as JTrainer
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig, TrainConfig
from clip_finegrained_alignment_tpu_torch.data import datasets as tds
from clip_finegrained_alignment_tpu_torch.data import packed as tpacked
from clip_finegrained_alignment_tpu_torch.data.synthetic import \
    generate_procedural_dataset
from clip_finegrained_alignment_tpu_torch.data.tokenizer import \
    HashTokenizer as THashTokenizer
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, save_reference_checkpoint, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.optim.factory import (
    make_optimizer, make_schedule)
from clip_finegrained_alignment_tpu_torch.train.checkpoint import \
    CheckpointManager
from clip_finegrained_alignment_tpu_torch.train.engine import (
    Trainer, install_preemption_handler)

CFG = CLIPConfig.tiny_test()
B, ACCUM, EPOCHS, SAMPLES = 4, 2, 2, 24
STEPS_PER_EPOCH = SAMPLES // (B * ACCUM)
TOK = dict(vocab_size=256, bos_token_id=254, eos_token_id=255,
           pad_token_id=0)


def _kw(loss_type, optimizer_type):
    return dict(clip_model="tiny", batch_size=B,
                gradient_accumulation_steps=ACCUM, lr=1e-3, use_amp=False,
                loss_type=loss_type, optimizer_type=optimizer_type,
                inverse_temperature=0.07 if loss_type == "sparc" else 1.0,
                max_epochs=EPOCHS, save_every=1, seed=0, log_every=100)


@pytest.fixture(scope="module")
def annotations(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture")
    generate_procedural_dataset(str(root), SAMPLES, image_size=64,
                                max_objects=3, seed=11)
    return os.path.join(str(root), "synthetic_annotations.json")


def _pipeline(ds_mod, tok_cls, annotations, loss_type):
    mode = "counterfactual" if loss_type == "count" else "standard"
    cls = ds_mod.CounterfactualCaptionDataset if mode == "counterfactual" \
        else ds_mod.SyntheticCaptionDataset
    return ds_mod.CountingDataPipeline(
        cls(annotations), B * ACCUM, mode=mode,
        image_size=CFG.vision.image_size,
        context_length=CFG.text.max_position_embeddings,
        tokenizer=tok_cls(**TOK), seed=0)


def _weights(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict()
            .items()}


def _assert_updates_close(got, want, initial):
    for k in initial:
        g = (got[k] - initial[k]).numpy()
        w = (want[k] - initial[k]).numpy()
        tol = 2e-3 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, \
            f"{k}: update err {np.abs(g - w).max()} > {tol}"


@pytest.mark.parametrize("loss_type,optimizer_type",
                         [("sparc", "adamspd"), ("count", "adamw")])
def test_trainer_epochs_match_jax(annotations, loss_type, optimizer_type):
    params = random_params(CFG, 0)
    jcfg = JaxTrainConfig(**_kw(loss_type, optimizer_type), warmup_steps=0,
                          remat=False, use_pallas_attention=True,
                          use_fused_sparc=True)
    jt = JTrainer(jcfg, params=jax.tree.map(jnp.array, params))
    jres = jt.train(_pipeline(jds, JHashTokenizer, annotations, loss_type),
                    num_epochs=EPOCHS, log_fn=None)

    cfg = TrainConfig(**_kw(loss_type, optimizer_type))
    initial = state_dict_from_jax(params, CFG)
    t = Trainer(cfg, initial, device="cpu")
    res = t.train(_pipeline(tds, THashTokenizer, annotations, loss_type),
                  num_epochs=EPOCHS, log_fn=None)

    assert [h["epoch"] for h in res["history"]] == list(range(EPOCHS))
    np.testing.assert_allclose([h["avg_loss"] for h in res["history"]],
                               [h["avg_loss"] for h in jres["history"]],
                               rtol=2e-5)
    assert t.global_step == jt.global_step == EPOCHS * STEPS_PER_EPOCH
    assert res["global_step"] == jres["global_step"]
    np.testing.assert_allclose(t.best_loss, jt.best_loss, rtol=2e-5)
    assert not res["preempted"] and not jres["preempted"]
    assert all(h["pairs_per_sec"] > 0 for h in res["history"])
    _assert_updates_close(_weights(t), state_dict_from_jax(jt.params, CFG),
                          initial)


def _sparc_trainer(manager=None, pixel_bank=None):
    return Trainer(TrainConfig(**_kw("sparc", "adamspd")),
                   state_dict_from_jax(random_params(CFG, 0), CFG),
                   device="cpu", checkpoint_manager=manager,
                   pixel_bank=pixel_bank)


def _assert_equal_state(a, b):
    assert a.global_step == b.global_step
    assert a.best_loss == b.best_loss
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"]
    for i, st in sa["optimizer"]["state"].items():
        other = sb["optimizer"]["state"][i]
        assert sorted(st) == sorted(other)
        for k, v in st.items():
            assert (torch.equal(v, other[k]) if torch.is_tensor(v)
                    else v == other[k]), (i, k)


@pytest.fixture(scope="module")
def packed_dir(annotations, tmp_path_factory):
    out = tmp_path_factory.mktemp("packed")
    tpacked.pack_dataset(annotations, str(out), image_size=32,
                         context_length=CFG.text.max_position_embeddings,
                         tokenizer=THashTokenizer(**TOK))
    return str(out)


@pytest.fixture(scope="module")
def unbroken(packed_dir):
    """Two epochs of SPARC + AdamSPD from the pack, unbroken."""
    pipe = tpacked.PackedDataPipeline(packed_dir, B * ACCUM, seed=0)
    t = _sparc_trainer()
    res = t.train(pipe, num_epochs=EPOCHS, log_fn=None)
    return t, res


def test_pixel_bank_path_equals_pixel_path(packed_dir, unbroken):
    pipe = tpacked.PackedDataPipeline(packed_dir, B * ACCUM, seed=0,
                                      index_only=True)
    t = _sparc_trainer(pixel_bank=pipe.pixel_bank())
    assert t.pixel_bank.dtype == torch.uint8
    assert t.pixel_bank.shape == (SAMPLES, 32, 32, 3)
    assert "pixel_values" not in next(iter(pipe.epoch(0)))
    res = t.train(pipe, num_epochs=EPOCHS, log_fn=None)
    ref, ref_res = unbroken
    assert [h["avg_loss"] for h in res["history"]] == \
        [h["avg_loss"] for h in ref_res["history"]]
    _assert_equal_state(t, ref)


def test_checkpoint_round_trip_equals_the_unbroken_run(packed_dir, unbroken,
                                                       tmp_path):
    pipe = tpacked.PackedDataPipeline(packed_dir, B * ACCUM, seed=0)
    manager = CheckpointManager(str(tmp_path), save_every=1)
    first = _sparc_trainer(manager)
    first.train(pipe, num_epochs=1, log_fn=None)
    assert sorted(os.listdir(tmp_path)) == ["best", "epoch_0"]
    with open(tmp_path / "epoch_0" / "meta.json") as f:
        meta = json.load(f)
    assert set(meta) == {"epoch", "global_step", "best_loss", "avg_loss",
                         "preempted", "config"}
    assert meta["global_step"] == STEPS_PER_EPOCH and not meta["preempted"]
    assert TrainConfig.from_dict(meta["config"]) == first.cfg

    resumed = _sparc_trainer(manager)
    state, meta = manager.restore("epoch_0", config=resumed.cfg)
    resumed.load_state_dict(state)
    resumed.global_step = meta["global_step"]
    resumed.best_loss = meta["best_loss"]
    res = resumed.train(pipe, num_epochs=EPOCHS, start_epoch=1, log_fn=None)
    ref, ref_res = unbroken
    assert res["history"][0]["avg_loss"] == ref_res["history"][1]["avg_loss"]
    _assert_equal_state(resumed, ref)
    # AdamSPD's anchors came back with the checkpoint: the initial weights.
    initial = state_dict_from_jax(random_params(CFG, 0), CFG)
    anchors = [s["anchor"] for s in
               resumed.optimizer.state_dict()["optimizer"]["state"].values()]
    names = [n for n, _ in resumed.model.named_parameters()]
    for n, a in zip(names, anchors):
        assert torch.equal(a, initial[n]), n


def test_preempt_then_resume_equals_the_unbroken_run(packed_dir, unbroken,
                                                     tmp_path):
    pipe = tpacked.PackedDataPipeline(packed_dir, B * ACCUM, seed=0)
    manager = CheckpointManager(str(tmp_path), save_every=1)
    t = _sparc_trainer(manager)
    step = t.step

    def step_then_preempt(batch):
        out = step(batch)
        if t.global_step == 1:
            t.request_preempt()
        return out

    t.step = step_then_preempt
    res = t.train(pipe, num_epochs=EPOCHS, log_fn=None)
    assert res["preempted"] and res["global_step"] == 1
    assert sorted(os.listdir(tmp_path)) == ["preempt"]
    with open(tmp_path / "preempt" / "meta.json") as f:
        meta = json.load(f)
    assert meta["preempted"] is True and meta["global_step"] == 1
    assert meta["epoch"] == 0

    resumed = _sparc_trainer(manager)
    state, meta = manager.restore("preempt")
    resumed.load_state_dict(state)
    resumed.global_step = meta["global_step"]
    skip = {"n": meta["global_step"] % STEPS_PER_EPOCH}

    def batches(epoch):  # the CLI's step-exact skip
        n = skip.pop("n", 0)
        for i, batch in enumerate(pipe.epoch(epoch)):
            if i >= n:
                yield batch

    resumed.train(batches, num_epochs=EPOCHS, log_fn=None)
    ref, _ = unbroken
    assert resumed.global_step == ref.global_step
    for k, v in ref.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_preemption_handler_requests_a_preempt_and_chains():
    t = _sparc_trainer()
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda *a: seen.append(a[0]))
    try:
        install_preemption_handler(t, signals=(signal.SIGUSR1,))
        assert not t.preempt_requested
        signal.raise_signal(signal.SIGUSR1)
        assert t.preempt_requested and seen == [signal.SIGUSR1]
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_restore_warns_on_config_drift_and_prunes(tmp_path):
    t = _sparc_trainer()
    manager = CheckpointManager(str(tmp_path), save_every=1,
                                keep_periodic=2)
    for epoch in range(4):
        manager.save(epoch=epoch, state=t.state_dict(), global_step=epoch,
                     best_loss=1.0, avg_loss=1.0, is_best=epoch == 3,
                     config=t.cfg)
    assert sorted(os.listdir(tmp_path)) == ["best", "epoch_2", "epoch_3"]
    assert manager.latest_epoch() == 3
    # One save to best/ and epoch_3/: one file, hard-linked.
    assert os.path.samefile(tmp_path / "best" / "state.pt",
                            tmp_path / "epoch_3" / "state.pt")
    assert not [f for f in os.listdir(tmp_path / "best") if ".tmp" in f]
    drift = TrainConfig(**{**_kw("sparc", "adamspd"), "lr": 5e-4})
    with pytest.warns(UserWarning, match="lr was 0.001, now 0.0005"):
        manager.restore("best", config=drift)
    with pytest.raises(FileNotFoundError):
        manager.restore("epoch_0")
    os.unlink(tmp_path / "epoch_2" / "meta.json")
    with pytest.raises(RuntimeError, match="meta.json"):
        manager.restore("epoch_2")


def test_jax_reads_the_reference_export(tmp_path):
    t = _sparc_trainer()
    t.model.logit_scale.data.fill_(3.25)   # a weight off its initial value
    path = str(tmp_path / "ref.pt")
    save_reference_checkpoint(path, t.model, CFG, global_step=17,
                              best_loss=0.125, config=t.cfg.to_dict())
    from clip_finegrained_alignment_tpu.config import CLIPConfig as JCLIP
    params, meta = hf_import.load_reference_checkpoint(path,
                                                       JCLIP.tiny_test())
    assert meta["global_step"] == 17 and meta["best_loss"] == 0.125
    assert meta["config"]["loss_type"] == "sparc"
    back = state_dict_from_jax(params, CFG)
    sd = t.model.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="does not fit"):
        save_reference_checkpoint(path, t.model, CLIPConfig.vit_b16())


def test_warmup_schedule_matches_optax():
    cfg = TrainConfig(lr=3e-4, warmup_steps=10)
    sched = make_schedule(cfg, use_warmup=True)
    ref = optax.linear_schedule(0.0, cfg.lr, cfg.warmup_steps)
    for step in (0, 5, 10, 25):
        np.testing.assert_allclose(sched(step), float(ref(step)),
                                   rtol=1e-6, atol=0)
    assert make_schedule(cfg) == cfg.lr == make_schedule(
        TrainConfig(lr=3e-4, warmup_steps=0), use_warmup=True)
    # The optimizer reads it a step at a time: lr 0 for the first update.
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer(cfg, [("w", p)], use_warmup=True)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3)) and opt.count == 1
    p.grad = torch.ones(3)
    opt.step()
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(3e-5)
    assert (p.detach() < 1).all()


def test_logging_utilities_match_jax(tmp_path, capsys):
    from clip_finegrained_alignment_tpu.utils import logging as jlog
    from clip_finegrained_alignment_tpu_torch.utils import logging as tlog
    recs, echoes = {}, {}
    for name, mod, value in (("jax", jlog, np.float32(1.5)),
                             ("port", tlog, torch.tensor(1.5))):
        path = tmp_path / f"{name}.jsonl"
        logger = mod.MetricsLogger(str(path))
        logger.log(3, loss=value, note="x", n=2)
        logger.log(4, pairs_per_sec_enqueue=12.25)
        logger.close()
        with open(path) as f:
            recs[name] = [{k: v for k, v in json.loads(line).items()
                           if k != "time"} for line in f]
        echoes[name] = capsys.readouterr().err
    assert recs["port"] == recs["jax"] == [
        {"step": 3, "loss": 1.5, "note": "x", "n": 2.0},
        {"step": 4, "pairs_per_sec_enqueue": 12.25}]
    assert echoes["port"] == echoes["jax"]
    assert tlog.is_main_process()

    with tlog.span("fwd", micro=0) as s:
        torch.ones(8).sum()
    (rec,) = tlog.spans("fwd", since_ns=s.start_ns)
    assert rec.end_ns >= rec.start_ns and rec.attrs == {"micro": 0}
    assert capsys.readouterr().out == ""     # spans print nothing
    meter = tlog.ThroughputMeter(num_chips=1)
    assert meter.tick(8) is None and meter.tick(8) > 0
    assert set(meter.report()) == set(
        jlog.ThroughputMeter(num_chips=1).report())
