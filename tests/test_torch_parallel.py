"""The port's data parallelism (``clip_finegrained_alignment_tpu_torch/
parallel/``, the mesh path of ``train/engine.py``) at W = 2 gloo processes
on the CPU (``parallel/launch.py::spawn``, rank functions in
``tests/test_torch_parallel_workers.py``), held to the JAX package's mesh
path on two of the virtual CPU devices (``MeshConfig(data=2)``) and to
the port's own single process, from the same numpy weights and batches.

Tolerances are those of the matching JAX tests (``tests/
test_train_engine.py``): losses rtol 1e-5, ``grad_norm`` rtol 1e-4,
parameters after the steps rtol 2e-4 / atol 2e-5. Bit-exact where the
math is the same program: checkpoints across rank counts, resume.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_workers as W
from clip_finegrained_alignment_tpu.config import \
    CLIPConfig as JaxCLIPConfig, MeshConfig as JaxMeshConfig, \
    TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.models import clip as jm
from clip_finegrained_alignment_tpu.optim.factory import \
    make_optimizer as jax_make_optimizer
from clip_finegrained_alignment_tpu.parallel import mesh as jmesh
from clip_finegrained_alignment_tpu.parallel import sharding_rules as jsr
from clip_finegrained_alignment_tpu.train.engine import \
    make_train_step as jax_make_train_step
from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                         MeshConfig)
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.parallel import sharding_rules
from clip_finegrained_alignment_tpu_torch.parallel.launch import spawn
from clip_finegrained_alignment_tpu_torch.parallel.mesh import Mesh
from clip_finegrained_alignment_tpu_torch.train.checkpoint import \
    CheckpointManager
from clip_finegrained_alignment_tpu_torch.train.engine import (
    Trainer, check_parallel)
from clip_finegrained_alignment_tpu_torch.train.gradcache import \
    validate_gradcache

JCFG = JaxCLIPConfig.tiny_test()
SPAWN_S = 240


def _jax_config(**kw):
    cfg = W.train_config(**kw)
    fields = ("batch_size", "gradient_accumulation_steps", "lr", "use_amp",
              "loss_type", "optimizer_type", "inverse_temperature",
              "global_negatives", "warmup_steps", "log_every")
    return JaxTrainConfig(clip_model="tiny", remat=False,
                          mesh=JaxMeshConfig(data=2),
                          **{f: getattr(cfg, f) for f in fields})


def jax_mesh_step(kw, seed, batch_seed, devices):
    """One step of the JAX package's mesh path (data=2) → (metrics, the
    updated weights under HF names)."""
    jcfg = _jax_config(**kw)
    params = jax.tree.map(jnp.asarray, random_params(W.CFG, seed))
    opt = jax_make_optimizer(jcfg, params)
    mesh = jmesh.make_mesh(JaxMeshConfig(data=2), devices[:2])
    step = jax_make_train_step(jcfg, JCFG, opt, mesh=mesh)
    batch = W.make_batch(batch_seed, jcfg.loss_type)
    p, _, metrics = step(jmesh.replicate(params, mesh),
                         jmesh.replicate(opt.init(params), mesh),
                         jmesh.shard_batch(batch, mesh, accum_axis=True))
    p = jax.tree.map(np.asarray, p)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in state_dict_from_jax(p, W.CFG).items()})


def one_process_step(kw, seed, batch_seed, steps=1):
    """The port's own step with no mesh on the whole global batch."""
    cfg = W.train_config(**kw)
    t = Trainer(cfg, W.initial_state(seed), device="cpu")
    batch = W.make_batch(batch_seed, cfg.loss_type)
    metrics = [{k: float(v) for k, v in t.train_step(batch).items()}
               for _ in range(steps)]
    return metrics, W.numpy_state(t.state_dict())


def assert_params_close(got, want, rtol=2e-4, atol=2e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def assert_same_state(got, want, path="state"):
    """Bit for bit, nested dicts of numpy and scalars."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same_state(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert np.array_equal(got, want), path
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_state(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


# ---------------------------------------------------------------------------
# No processes: the shard-dim rule and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["tiny", "ViT-B/16"])
@pytest.mark.parametrize("dp", [2, 4])
def test_shard_dim_rule_matches_jax_specs(model, dp, eight_devices):
    """Leaf by leaf, the dim the port splits equals the dim JAX's
    zero1_opt_specs / fsdp_param_specs put on ``data``."""
    cfg = JaxCLIPConfig.from_name(model)
    params = jax.eval_shape(lambda: jm.init_clip_params(
        jax.random.key(0), cfg))
    opt_state = jax.eval_shape(jax_make_optimizer(
        _jax_config(optimizer_type="adamspd"), params).init, params)
    mesh = jmesh.make_mesh(JaxMeshConfig(data=dp), eight_devices[:dp])
    for tree, specs, port_specs in (
            (params, jsr.fsdp_param_specs(params, mesh),
             sharding_rules.fsdp_param_specs),
            (opt_state, jsr.zero1_opt_specs(opt_state, mesh),
             sharding_rules.zero1_opt_specs)):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        shapes = {jax.tree_util.keystr(p): getattr(x, "shape", ())
                  for p, x in leaves}
        want = {jax.tree_util.keystr(p): next(
            (i for i, a in enumerate(s) if a == jmesh.DATA_AXIS), None)
            for p, s in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda s: isinstance(s, jax.sharding.
                                                    PartitionSpec))}
        assert port_specs(shapes, dp) == want
        assert any(d is not None for d in want.values())


# The cases keep the ids they had when tensor, pipeline and sequence
# parallelism were all refused (ROADMAP A6b); they now hold JAX's
# refusals.
REFUSALS = [
    (dict(fsdp=True), "global_negatives"),
    (dict(fsdp=True, global_negatives=True, zero1=True), "subsumes"),
    pytest.param(dict(mesh=MeshConfig(data=1, model=2)),
                 r"tensor parallelism \(mesh.model > 1\) requires "
                 "global_negatives", id="kw2-A6b"),
    pytest.param(dict(mesh=MeshConfig(data=1, pipe=2)),
                 r"pipeline parallelism \(mesh.pipe > 1\) requires "
                 "global_negatives", id="kw3-A6b"),
    pytest.param(dict(sequence_parallel=True, global_negatives=True,
                      mesh=MeshConfig(data=2)),
                 r"sequence_parallel needs mesh.model > 1", id="kw4-A6b"),
    pytest.param(dict(sequence_parallel=True, sp_ring=True,
                      mesh=MeshConfig(data=1, model=2)),
                 "sequence parallelism requires global_negatives=True",
                 id="kw5-A6b"),
    pytest.param(dict(pipeline_microbatches=3, global_negatives=True,
                      mesh=MeshConfig(data=1, pipe=2)),
                 "batch_size 8 not divisible by pipeline_microbatches 3",
                 id="kw6-A6b"),
]


@pytest.mark.parametrize("kw,message", REFUSALS)
def test_step_refuses_what_it_cannot_build(kw, message):
    with pytest.raises(ValueError, match=message):
        check_parallel(W.train_config(**kw))
    with pytest.raises(ValueError, match=message):
        Trainer(W.train_config(**kw), W.initial_state(0), device="cpu")


@pytest.mark.parametrize("kw,message", REFUSALS[:2])
def test_fsdp_refusals_are_jax_s(kw, message, eight_devices):
    """The same configurations JAX's make_train_step refuses, with the
    same words."""
    jcfg = dataclasses.replace(_jax_config(), **kw)
    params = jm.init_clip_params(jax.random.key(0), JCFG)
    mesh = jmesh.make_mesh(JaxMeshConfig(data=8), eight_devices)
    with pytest.raises(ValueError, match=message):
        jax_make_train_step(jcfg, JCFG, jax_make_optimizer(jcfg, params),
                            mesh=mesh)


def test_shard_batch_keeps_the_rank_rows_and_refuses_a_global_batch():
    """Rank r of W keeps rows [r·B/W, (r+1)·B/W) of the second dim, as
    JAX's batch_sharding(accum_axis=True); a rank's pipeline batch must
    hold B/W rows (one built at the global size trains on W times it)."""
    from clip_finegrained_alignment_tpu_torch.parallel import mesh as pm
    batch = W.make_batch(0, "count")
    mesh = Mesh(data=2, rank=1, device=torch.device("cpu"))
    rows = pm.shard_batch(batch, mesh, accum_axis=True)
    for k, x in batch.items():
        assert np.array_equal(rows[k], x[:, 4:8]), k
    assert pm.shard_batch_from_local(rows, mesh, accum_axis=True,
                                     rows=4) == rows
    with pytest.raises(ValueError, match="effective_batch_size / W"):
        pm.shard_batch_from_local(batch, mesh, accum_axis=True, rows=4)
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_batch({"x": np.zeros((2, 7))}, mesh, accum_axis=True)
    trainer = Trainer(W.train_config(), W.initial_state(0), device="cpu")
    trainer.mesh = mesh   # the check alone: no step is taken
    with pytest.raises(ValueError, match="effective_batch_size / W"):
        trainer._device_batch({k: x.reshape((-1,) + x.shape[2:])
                               for k, x in W.make_batch(0, "clip").items()})


def test_gradcache_refuses_local_negatives_on_a_mesh():
    mesh = Mesh(data=2, rank=0, device=torch.device("cpu"))
    cfg = W.train_config(loss_type="sparc", grad_cache=True)
    with pytest.raises(ValueError, match="global_negatives"):
        validate_gradcache(cfg, mesh)
    validate_gradcache(cfg)   # one process: fine
    validate_gradcache(W.train_config(loss_type="sparc", grad_cache=True,
                                      global_negatives=True), mesh)
    with pytest.raises(ValueError, match="pipeline"):
        validate_gradcache(W.train_config(
            loss_type="clip", grad_cache=True, global_negatives=True,
            mesh=MeshConfig(data=1, pipe=2)), mesh)


# ---------------------------------------------------------------------------
# W = 2 gloo processes
# ---------------------------------------------------------------------------

def test_local_negatives_match_jax_parity_mode(eight_devices):
    """DDP semantics: each rank's loss on its own rows, the mean of the
    gradients. clip + AdamW and sparc + AdamSPD, one step each. With
    ``quant="int8"`` each rank's scales are its own rows' (JAX's per-rank
    ``shard_map``): the step runs no int8 collective and no split pass,
    and reads bit for bit as through the projections before the scales
    took groups."""
    cases = [dict(loss_type="clip", optimizer_type="adamw"),
             dict(loss_type="sparc", optimizer_type="adamspd")]
    ranks = spawn(W.local_negatives_cases, 2,
                  (cases[0], 1, 2, (cases[0], cases[1]),
                   dict(cases[1], quant="int8")), timeout_s=SPAWN_S)
    for r in ranks:
        assert r["calls"] == []
        assert r["int8"]["metrics"] == r["int8_before"]["metrics"]
        assert_same_state(r["int8"]["state"], r["int8_before"]["state"])
        assert np.isfinite(list(r["int8"]["metrics"][0].values())).all()
    ranks = [r["modes"] for r in ranks]
    for i, kw in enumerate(cases):
        jm_, jp = jax_mesh_step(kw, 1, 2, eight_devices)
        for r in ranks:
            got = r[i]["metrics"][0]
            np.testing.assert_allclose(got["total_loss"], jm_["total_loss"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], jm_["grad_norm"],
                                       rtol=1e-4)
            assert_params_close(r[i]["state"]["model"], jp)
        # Not the one-process global-batch step: the negatives are local.
        one, _ = one_process_step(kw, 1, 2)
        assert abs(one[0]["total_loss"] - jm_["total_loss"]) > 1e-3


@pytest.mark.parametrize("loss_type", ["clip", "sparc", "count",
                                       "clip_count"])
def test_global_negatives_match_jax_mesh_and_one_process(loss_type,
                                                         eight_devices):
    kw = dict(loss_type=loss_type, global_negatives=True,
              optimizer_type="adamspd" if loss_type in ("sparc", "count")
              else "adamw")
    seed = 3 + ["clip", "sparc", "count", "clip_count"].index(loss_type)
    ranks = spawn(W.run_steps, 2, (kw, seed, seed + 10, 1),
                  timeout_s=SPAWN_S)
    jm_, jp = jax_mesh_step(kw, seed, seed + 10, eight_devices)
    one, one_state = one_process_step(kw, seed, seed + 10)
    for r in ranks:
        got = r[0]["metrics"][0]
        for want in (jm_, one[0]):
            for k in want:
                np.testing.assert_allclose(
                    got[k], want[k], rtol=1e-4 if k == "grad_norm" else 1e-5,
                    err_msg=k)
        assert_params_close(r[0]["state"]["model"], jp)
        assert_params_close(r[0]["state"]["model"], one_state["model"])


@pytest.mark.parametrize("mode", ["zero1-local", "zero1-global", "fsdp"])
def test_zero1_and_fsdp_match_replicated(mode):
    """Three steps in the sharded layout equal the replicated layout's,
    with AdamSPD and with AdamW, and rank 0 holds under 0.6 of the
    replicated optimizer-state bytes. AdamSPD's anchors sit off the
    weights: its decisions read whole-tensor sums, which a shard's
    partial sums would move."""
    kw = dict(loss_type="sparc", optimizer_type="adamspd",
              global_negatives=mode != "zero1-local")
    layout = {"fsdp": True} if mode == "fsdp" else {"zero1": True}
    adamw = {"optimizer_type": "adamw"}
    ranks = spawn(W.run_steps, 2, (kw, 4, 5, 3, ({}, layout, adamw,
                                                 {**adamw, **layout}), True),
                  timeout_s=SPAWN_S)
    for r in ranks:
        for rep, sharded in (r[0:2], r[2:4]):
            for a, b in zip(rep["metrics"], sharded["metrics"]):
                np.testing.assert_allclose(b["total_loss"], a["total_loss"],
                                           rtol=1e-5)
                np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                           rtol=1e-4)
            assert_params_close(sharded["state"]["model"],
                                rep["state"]["model"])
            assert sharded["opt_bytes"] < 0.6 * rep["opt_bytes"], (
                sharded["opt_bytes"], rep["opt_bytes"])
    # The whole state each rank gathers is the same on both.
    for i in (1, 3):
        assert_same_state(ranks[1][i]["state"], ranks[0][i]["state"])


@pytest.mark.parametrize("loss_type", ["clip", "sparc"])
def test_gradcache_global_negatives_equal_one_process(loss_type):
    """GradCache at W = 2 with global negatives: one loss over both ranks'
    pools, equal to GradCache in one process on the same pool."""
    ranks = spawn(W.gradcache_case, 2, (loss_type, 8), timeout_s=SPAWN_S)
    kw = dict(loss_type=loss_type, grad_cache=True, optimizer_type="adamspd")
    one, one_state = one_process_step(kw, 8, 8)
    for r in ranks:
        for k, v in one[0].items():
            np.testing.assert_allclose(
                r["metrics"][k], v, rtol=1e-4 if k == "grad_norm" else 1e-5,
                err_msg=k)
        assert_params_close(r["state"]["model"], one_state["model"])


def test_checkpoints_across_rank_counts_resume_and_preempt(tmp_path):
    """Under ZeRO-1 and FSDP at W = 2: a checkpoint restores at W = 1 bit
    for bit, one written at W = 1 restores at W = 2 bit for bit, a resume
    at W = 2 is step-exact, and a preempt requested on rank 1 alone stops
    both ranks at the same step."""
    layouts = {"zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
    w1_dir = str(tmp_path / "w1")
    w1_cfg = W.train_config(optimizer_type="adamspd", global_negatives=True,
                            save_every=1)
    w1 = Trainer(w1_cfg, W.initial_state(9), device="cpu",
                 checkpoint_manager=CheckpointManager(w1_dir))
    w1.train(lambda e: [{k: x.reshape((-1,) + x.shape[2:]) for k, x in
                         W.make_batch(20, "clip").items()}], 1, log_fn=None)
    w1_file = W.numpy_state(CheckpointManager(w1_dir).restore("best")[0])

    ranks = spawn(W.checkpoint_cases, 2,
                  (layouts, str(tmp_path / "ckpt"), w1_dir),
                  timeout_s=SPAWN_S)
    for name, extra in layouts.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        assert all(np.isfinite(r0["losses"])) and r0["losses"] == r1["losses"]
        # Written whole by rank 0: the file is what every rank gathers.
        state, meta = CheckpointManager(
            str(tmp_path / "ckpt" / name)).restore("epoch_1")
        assert meta["config"][next(iter(extra))] is True
        assert meta["config"]["mesh"] == {"data": 2, "model": 1, "pipe": 1}
        saved = W.numpy_state(state)
        assert_same_state(saved, r0["unbroken"])
        assert_same_state(r1["unbroken"], r0["unbroken"])
        # ... and restores at W = 1 bit for bit.
        one = Trainer(W.train_config(optimizer_type="adamspd",
                                     global_negatives=True, **extra),
                      W.initial_state(7), device="cpu")
        one.load_state_dict(state)
        assert_same_state(W.numpy_state(one.state_dict()), saved)
        # Resume at W = 2 from epoch_0 is step-exact.
        assert r0["resumed_step"] == 4
        assert_same_state(r0["resumed"], r0["unbroken"])
        # Preempt on rank 1 alone: both stop after the same step.
        assert r0["preempted"] and r1["preempted"]
        assert r0["preempt_step"] == r1["preempt_step"] == 2
        assert os.path.exists(tmp_path / "ckpt" / f"{name}_p" / "preempt"
                              / "state.pt")
        # A W = 1 checkpoint restores at W = 2 bit for bit.
        assert_same_state(r0["w1_restored"], w1_file)
        assert_same_state(r1["w1_restored"], w1_file)


def test_one_rank_mesh_step_is_bit_equal_to_no_mesh():
    """On a one-rank group every collective is an identity: a
    global-negatives ZeRO-1 step through the mesh equals the step with no
    mesh bit for bit (``chip_smoke.py`` phase 10 runs it over NCCL)."""
    from clip_finegrained_alignment_tpu_torch.perf import \
        data_parallel_check as dpc
    got = spawn(dpc.one_rank_identity, 1, ("tiny", None, "float32", 8, 2, 0),
                timeout_s=SPAWN_S)[0]
    assert got["backend"] == "gloo" and got["world"] == 1
    assert got["metrics_equal"] and got["grads_equal"] \
        and got["params_equal"], got


@pytest.mark.parametrize("shard_sums_alone", [False, True])
def test_phase_10_gates(shard_sums_alone):
    """``chip_smoke.py`` phase 10's comparisons
    (``perf/data_parallel_check.py::rank_modes``) at tiny width, bf16:
    every mode within ``DP_LIMITS`` of its one-process oracle, and ZeRO-1's
    and FSDP's first update within ``DP_SHARD_MAX_FIRST_UPDATE_REL`` of
    global negatives replicated on the same ranks. With AdamSPD reading a
    shard's sums alone (trouble spot b) the oracle limits still pass and
    that gate fails."""
    import importlib.util
    from pathlib import Path
    from clip_finegrained_alignment_tpu_torch.perf import \
        data_parallel_check as dpc
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    limits = smoke.DP_LIMITS
    r0, r1 = spawn(W.phase_10_modes, 2,
                   (shard_sums_alone, "tiny", None, "bfloat16", 4, 2, 0, 3,
                    list(dpc.MODES)), timeout_s=SPAWN_S)
    for mode, res in r0.items():
        assert r1[mode]["metrics"] == res["metrics"], mode
        vs = res["vs_oracle"]
        assert vs["loss_rel"] <= limits["loss_rel"], (mode, vs)
        assert vs["grad_norm_rel"] <= limits["grad_norm_rel"], (mode, vs)
        assert vs["min_grad_cosine"] >= limits["min_grad_cosine"], (mode, vs)
        assert vs["min_update_cosine"] >= limits["min_update_cosine"], (
            mode, vs)
        if mode in ("zero1", "fsdp"):
            rel = res["vs_replicated"]["max_first_update_rel"]
            assert (rel > smoke.DP_SHARD_MAX_FIRST_UPDATE_REL) \
                == shard_sums_alone, (mode, rel)


def test_no_fallback_local_rank_and_backend(monkeypatch):
    """A LOCAL_RANK beyond the visible GPUs raises (nothing wraps it onto
    another device or the CPU), and a collective on a backend outside the
    port's route raises."""
    from clip_finegrained_alignment_tpu_torch.parallel import collectives
    from clip_finegrained_alignment_tpu_torch.parallel import mesh as pm
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 but 1 CUDA"):
        pm.distributed_init("cuda")
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda group=None: "mpi")
    with pytest.raises(RuntimeError, match="backend 'mpi'"):
        collectives.all_reduce_mean_([torch.zeros(2)])


def test_mesh_scorer_needs_a_batch_the_ranks_divide():
    from clip_finegrained_alignment_tpu_torch.eval.scoring import \
        TemplateScorer
    mesh = Mesh(data=2, rank=0, device=torch.device("cpu"))
    for pad in (None, 7):
        with pytest.raises(ValueError, match="divisible by the data axis"):
            TemplateScorer(W.initial_state(0), W.CFG, device="cpu",
                           pad_to_batch=pad, mesh=mesh)
