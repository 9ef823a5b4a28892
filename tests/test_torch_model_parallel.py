"""The port's tensor, pipeline and sequence parallelism
(``clip_finegrained_alignment_tpu_torch/parallel/``, ``models/clip.py``'s
TP layers, stages and token blocks, the mesh path of
``train/engine.py``) at 2 and 4 gloo processes on the CPU
(``parallel/launch.py::spawn``, rank functions in
``tests/test_torch_parallel_workers.py``), held to the JAX package's mesh
path on the virtual CPU devices and to the port's own single process,
from the same numpy weights and batches, at tiny widths with 2 layers a
tower (``pipe`` = 2 cuts each tower in two).

Tolerances are those of the matching JAX tests (``tests/test_pipeline.py``,
``tests/test_tensor_parallel.py``): losses rtol 1e-5, ``grad_norm`` rtol
1e-4, parameters after the steps rtol 3e-4 / atol 3e-5, fp32. Bit-exact
where the program is the same: checkpoints across layouts. The int8
layouts (``quant="int8"``) are held to the quantized tests' element
tolerances (``tests/test_torch_train.py``): the first step's loss rtol
2e-5 and norm 1e-4, at most 1 % of the first update's elements off by
more than 2e-3 of their tensor's largest update; the second step's loss
and norm within 5e-2.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

import test_torch_parallel_workers as W
from clip_finegrained_alignment_tpu.config import \
    CLIPConfig as JaxCLIPConfig, MeshConfig as JaxMeshConfig, \
    TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.models import clip as jm
from clip_finegrained_alignment_tpu.optim.factory import \
    make_optimizer as jax_make_optimizer
from clip_finegrained_alignment_tpu.parallel import mesh as jmesh
from clip_finegrained_alignment_tpu.parallel import pipeline as jpipe
from clip_finegrained_alignment_tpu.parallel import sharding_rules as jsr
from clip_finegrained_alignment_tpu.train.engine import Trainer as JaxTrainer
from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                         MeshConfig)
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.parallel import pipeline
from clip_finegrained_alignment_tpu_torch.parallel import sharding_rules
from clip_finegrained_alignment_tpu_torch.parallel.launch import spawn
from clip_finegrained_alignment_tpu_torch.train import engine
from clip_finegrained_alignment_tpu_torch.train.checkpoint import \
    CheckpointManager
from test_torch_parallel import (assert_params_close, assert_same_state,
                                 one_process_step)

SPAWN_S = 240
JAX_PARAMS = dict(rtol=3e-4, atol=3e-5)


# ---------------------------------------------------------------------------
# No processes: the rules against JAX's specs, the refusals
# ---------------------------------------------------------------------------

def _jax_leaf_to_torch(keys, shape, cfg):
    """A JAX params leaf → [(HF name, {JAX dim: torch dim or None})] of
    the torch tensors it becomes (one a layer for stacked leaves)."""
    tower = {"vision": "vision_model", "text": "text_model"}.get(keys[0])
    lin = {0: 1, 1: 0}                      # kernel [in, out] → [out, in]
    if tower and keys[1] == "layers":
        mod = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
               "v": "self_attn.v_proj", "out": "self_attn.out_proj",
               "fc1": "mlp.fc1", "fc2": "mlp.fc2", "ln1": "layer_norm1",
               "ln2": "layer_norm2"}[keys[2]]
        param = {"kernel": "weight", "scale": "weight",
                 "bias": "bias"}[keys[3]]
        dims = {0: None, 1: 1, 2: 0} if keys[3] == "kernel" \
            else {0: None, 1: 0}
        return [(f"{tower}.encoder.layers.{i}.{mod}.{param}", dims)
                for i in range(shape[0])]
    return [(None, dict(enumerate(range(len(shape))))
             if "kernel" not in keys[-1] else lin)]


def _axis_dim(spec, axis):
    return next((i for i, a in enumerate(spec) if a == axis), None)


@pytest.mark.parametrize("model", ["tiny", "ViT-B/16"])
def test_tp_and_composed_rules_match_jax_specs(model, eight_devices):
    """On a 2 x 2 x 2 mesh, every encoder-layer leaf: the dim the port
    splits over ``model`` (``tp_dim``) is the dim JAX's ``param_specs`` and
    ``composed_param_specs`` put on ``model``, mapped through [L, in, out]
    → [out, in]; JAX's ``pipe`` axis is on the L dim, the layer index (the
    stage each rank holds is checked in the steps below); and the dim the
    port splits over ``data`` on top
    (``data_shard_dim`` with the TP dim taken) is the one
    ``fsdp_param_specs`` and ``zero1_opt_specs`` pick. Leaves outside the
    layers are whole over model and pipe on both sides."""
    cfg = JaxCLIPConfig.from_name(model)
    params = jax.eval_shape(lambda: jm.init_clip_params(jax.random.key(0),
                                                        cfg))
    mesh = jmesh.make_mesh(JaxMeshConfig(data=2, model=2, pipe=2),
                           eight_devices)
    opt_state = jax.eval_shape(jax_make_optimizer(JaxTrainConfig(
        clip_model=model, optimizer_type="adamspd"), params).init, params)
    is_spec = (lambda s: isinstance(s, PartitionSpec))

    def by_key(specs, prefix=""):
        return {jax.tree_util.keystr(p)[len(prefix):]: s
                for p, s in jax.tree_util.tree_leaves_with_path(
                    specs, is_leaf=is_spec)
                if jax.tree_util.keystr(p).startswith(prefix)}
    tp_specs = by_key(jsr.param_specs(params))
    composed = by_key(jsr.composed_param_specs(params, mesh))
    fsdp = by_key(jsr.fsdp_param_specs(params, mesh))
    zero1 = by_key(jsr.zero1_opt_specs(opt_state, mesh), "[1].mu")
    checked = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = tuple(getattr(k, "key", None) or str(k) for k in path)
        key = jax.tree_util.keystr(path)
        tp, comp, fs, zs = (tp_specs[key], composed[key], fsdp[key],
                            zero1[key])
        for name, dims in _jax_leaf_to_torch(keys, leaf.shape, cfg):
            if name is None:        # outside the layers: whole over both
                assert _axis_dim(tp, "model") is None, key
                assert _axis_dim(comp, "model") is None \
                    and _axis_dim(comp, "pipe") is None, key
                continue
            L = leaf.shape[0]
            want_tp = dims.get(_axis_dim(tp, "model"))
            assert sharding_rules.tp_dim(name) == want_tp, (key, name)
            assert dims.get(_axis_dim(comp, "model")) == want_tp, key
            assert _axis_dim(comp, "pipe") == 0, key
            assert sharding_rules.layer_index(name) < L
            shape = [0] * len(leaf.shape[1:])
            for jd, td in dims.items():
                if td is not None:
                    shape[td] = leaf.shape[jd]
            got = sharding_rules.data_shard_dim(tuple(shape), 2,
                                                taken=want_tp)
            assert dims.get(_axis_dim(fs, "data")) == got, (key, fs, got)
            assert dims.get(_axis_dim(zs, "data")) == got, (key, zs, got)
            checked += 1
    assert checked == 16 * (cfg.vision.num_layers + cfg.text.num_layers)


def _torch_shapes(cfg):
    import torch
    from clip_finegrained_alignment_tpu_torch.models import clip as tm
    with torch.device("meta"):
        model = tm.CLIPModel(cfg)
    return {n: p.shape for n, p in model.named_parameters()}


def test_divisibility_and_microbatch_refusals():
    """``validate_tp_divisibility`` and ``validate_pipe_divisibility``
    raise before anything is built, with JAX's words; the microbatch
    default is 2 x the stages."""
    cfg = CLIPConfig.tiny_test()
    shapes = _torch_shapes(cfg)
    sharding_rules.validate_tp_divisibility(shapes, 2)
    bad = dict(shapes)
    bad["vision_model.encoder.layers.0.mlp.fc1.weight"] = (67, 32)
    with pytest.raises(ValueError, match="divisibility"):
        sharding_rules.validate_tp_divisibility(bad, 2)
    with pytest.raises(ValueError, match="2 heads not divisible"):
        sharding_rules.validate_tp_divisibility(shapes, 4, {"vision": 2})
    pipeline.validate_pipe_divisibility(cfg, MeshConfig(pipe=2), 8)
    with pytest.raises(ValueError, match="not divisible by pipe=4"):
        pipeline.validate_pipe_divisibility(cfg, MeshConfig(pipe=4), 8)
    with pytest.raises(ValueError, match="batch_size"):
        pipeline.validate_pipe_divisibility(cfg, MeshConfig(pipe=2), 6)
    # The same calls on the JAX side raise alike.
    jpipe.validate_pipe_divisibility(JaxCLIPConfig.tiny_test(),
                                     JaxMeshConfig(pipe=2), 8)
    with pytest.raises(ValueError, match="batch_size"):
        jpipe.validate_pipe_divisibility(JaxCLIPConfig.tiny_test(),
                                         JaxMeshConfig(pipe=2), 6)
    assert pipeline.default_num_micro(4) == jpipe.default_num_micro(4) == 8
    assert pipeline.default_num_micro(4, 2) == 2
    # A layout named in the config needs the group's mesh.
    with pytest.raises(ValueError, match="make_mesh"):
        engine.Trainer(W.train_config(global_negatives=True,
                                      mesh=MeshConfig(model=2)),
                       W.initial_state(0), device="cpu")


REFUSED = [
    (dict(mesh=MeshConfig(model=2), grad_cache=True, loss_type="sparc",
          global_negatives=True, sequence_parallel=True),
     "grad_cache is not supported with sequence_parallel"),
    (dict(mesh=MeshConfig(pipe=2), grad_cache=True, loss_type="sparc",
          global_negatives=True), "grad_cache is not supported with "
     "pipeline parallelism"),
]


@pytest.mark.parametrize("kw,message", REFUSED)
def test_gradcache_refusals_follow_jax(kw, message):
    """GradCache: sequence and pipeline parallelism refused with JAX's
    words; under TP alone it is accepted."""
    from clip_finegrained_alignment_tpu_torch.parallel.mesh import Mesh
    from clip_finegrained_alignment_tpu_torch.train.gradcache import \
        validate_gradcache
    cfg = W.train_config(**kw)
    with pytest.raises(ValueError, match=message):
        engine.check_parallel(cfg)
        validate_gradcache(cfg, Mesh(data=1, rank=0, device="cpu"))
    validate_gradcache(W.train_config(
        loss_type="sparc", grad_cache=True, global_negatives=True,
        mesh=MeshConfig(model=2)), Mesh(data=1, rank=0, device="cpu",
                                        model=2))


# ---------------------------------------------------------------------------
# Gloo processes: steps against JAX's mesh and one process
# ---------------------------------------------------------------------------

def jax_mp_steps(kw, mesh_kw, seed, batch_seed, devices, steps):
    """``steps`` steps of the JAX package's Trainer on the mesh
    ``mesh_kw`` (its own TP, PP, composed, ZeRO-1 and FSDP layouts) →
    (metrics per step, the updated weights under HF names, the weights
    after the first step)."""
    cfg = W.train_config(**kw)
    fields = ("batch_size", "gradient_accumulation_steps", "lr", "use_amp",
              "loss_type", "optimizer_type", "inverse_temperature",
              "global_negatives", "warmup_steps", "log_every", "zero1",
              "fsdp", "pipeline_microbatches", "sequence_parallel",
              "sp_ring", "quant")
    mcfg = JaxMeshConfig(**mesh_kw)
    jcfg = JaxTrainConfig(clip_model="tiny", remat=False, mesh=mcfg,
                          **{f: getattr(cfg, f) for f in fields})
    n = mcfg.data * mcfg.model * mcfg.pipe
    mesh = jmesh.make_mesh(mcfg, devices[:n])
    t = JaxTrainer(jcfg, params=jax.tree.map(
        jnp.asarray, random_params(W.CFG, seed)), mesh=mesh)
    batch = W.make_batch(batch_seed, cfg.loss_type,
                         cfg.gradient_accumulation_steps, cfg.batch_size)
    flat = {k: x.reshape((-1,) + x.shape[2:]) for k, x in batch.items()}

    def hf():
        p = jax.tree.map(np.asarray, t.params)
        return {k: v.numpy()
                for k, v in state_dict_from_jax(p, W.CFG).items()}
    metrics, first = [], None
    for s in range(steps):
        metrics.append({k: float(v) for k, v in t.step(flat).items()})
        if s == 0:
            first = hf()
    return metrics, hf(), first


SPARC = dict(loss_type="sparc", optimizer_type="adamspd",
             global_negatives=True)
COUNT = dict(loss_type="count", global_negatives=True)
GRADCACHE = dict(SPARC, grad_cache=True)
QUANT = dict(SPARC, quant="switchback")
INT8 = dict(SPARC, quant="int8")
LOSSES = {"sparc": SPARC, "count": COUNT, "gradcache": GRADCACHE,
          "quant": QUANT, "int8": INT8,
          "gradcache_int8": dict(GRADCACHE, quant="int8")}
TP2 = dict(data=1, model=2, pipe=1)
PP2 = dict(data=1, model=1, pipe=2)
DP2 = dict(data=2, model=1, pipe=1)
SP = {"sequence_parallel": True}
SP_RING = {"sequence_parallel": True, "sp_ring": True}
# (name, mesh, base, layout fields, against JAX's mesh step too): each
# layout's two steps, grouped so that one spawn runs a group (with phase
# 11's gates on two ranks, the checkpoints on four); the two-rank layouts
# in two groups of about one length, which xdist runs side by side.
GROUPS = {
    "two_ranks": [
        ("tp", TP2, "sparc", {}, True),
        ("pp", PP2, "sparc", {}, True),
        # The count loss pipelines its extra [B·N, T] text forward too (the
        # port's one process is held to JAX's in test_torch_train.py).
        ("pp_count", PP2, "count", {}, False),
        # GradCache under TP: one process's GradCache step, the same loss
        # over the pool (held to JAX's in test_torch_gradcache.py).
        ("tp_gradcache", TP2, "gradcache", {}, False),
        # switchback under PP: no contraction is split and its wgrad is
        # exact, so the first step is one process's; later steps within
        # the quantized tests' 5e-2.
        ("pp_quant", PP2, "quant", {}, False),
        # int8 under TP: the split contractions' scales over the model
        # ranks, the int32 sums summed (JAX's GSPMD step).
        ("tp_int8", TP2, "int8", {}, True),
        # int8 under PP: each GPipe microbatch's wgrad quantized alone, as
        # JAX's shard_map over pipe does, so not one process's step.
        ("pp_int8", PP2, "int8", {}, "only"),
        # GradCache under TP with int8: one process's GradCache int8 step.
        ("tp_gradcache_int8", TP2, "gradcache_int8", {}, False)],
    "two_ranks_sp": [
        # int8 with global negatives on two data ranks: the wgrad's scales
        # over both ranks' rows (ROADMAP C7; its gates below show the old
        # path failing). Here for the two groups' balance.
        ("dp2_int8", DP2, "int8", {}, False),
        # Sequence parallelism (the model axis the sequence axis): GSPMD
        # SP, the ring, and the count loss's [B·N, T] text forward.
        ("sp", TP2, "sparc", SP, True),
        ("sp_ring", TP2, "sparc", SP_RING, True),
        ("sp_count", TP2, "count", SP, True),
        # int8 under SP: the wgrad's scales over both ranks' token blocks
        # (the patch embedding's too: its cotangent is this rank's block).
        ("sp_int8", TP2, "int8", SP, True)],
    "four_ranks": [
        ("tp_pp", dict(data=1, model=2, pipe=2), "sparc", {}, True),
        ("tp_zero1", dict(data=2, model=2, pipe=1), "sparc",
         {"zero1": True}, True),
        ("tp_fsdp", dict(data=2, model=2, pipe=1), "sparc", {"fsdp": True},
         True),
        ("pp_fsdp", dict(data=2, model=1, pipe=2), "sparc", {"fsdp": True},
         True),
        # A ring of four (every rank's hops in two pair groups) and SP
        # under ZeRO-1 and FSDP over two data ranks.
        ("sp4_ring", dict(data=1, model=4, pipe=1), "sparc", SP_RING, True),
        ("dp2sp2_zero1", dict(data=2, model=2, pipe=1), "sparc",
         dict(SP, zero1=True), True),
        ("dp2sp2_ring_fsdp", dict(data=2, model=2, pipe=1), "sparc",
         dict(SP_RING, fsdp=True), True),
        # int8 over data x model with FSDP: the model group's scales and
        # the data group's wgrad scales at once.
        ("dp2tp2_int8_fsdp", dict(data=2, model=2, pipe=1), "int8",
         {"fsdp": True}, False)],
}
# Each two-rank group's (fault, modes, dtype). The sequence modes run in
# fp32: at the tiny width (32) bf16 alone moves the ring's first AdamSPD
# update to a cosine of 0.987 (tp2 0.992) against one process, where the
# ViT-B/16-wide study behind SP_LIMITS reads 0.9999 in bf16; in fp32 the
# gates see the faults alone. The int8 modes are held to INT8_LIMITS, and
# the fault of every scale taken locally must fail them; dp2-int8 (ROADMAP
# C7) in fp32, as there bf16 alone moves 6.6 % of the first update's
# elements at the tiny width (the fault 16.4 %), in fp32 0.002 % (15.7 %).
GATE_CASES = {
    "two_ranks": [(None, ["tp2", "pp2", "tp2-int8"], "bfloat16"),
                  ("pipe_summed_post", ["pp2"], "bfloat16"),
                  ("tp_sums_alone", ["tp2"], "bfloat16"),
                  ("norm_counts_tp", ["tp2"], "bfloat16"),
                  ("quant_shard_scales", ["tp2-int8"], "bfloat16")],
    "two_ranks_sp": [(None, ["sp2", "sp2-ring", "sp2-int8", "dp2-int8"],
                      "float32"),
                     ("norm_counts_tp", ["sp2-ring"], "float32"),
                     ("gather_sums_cotangent", ["sp2", "sp2-ring"],
                      "float32"),
                     ("post_gather_summed", ["sp2"], "float32"),
                     ("quant_shard_scales", ["sp2-int8", "dp2-int8"],
                      "float32")]}
CHECKPOINT_LAYOUTS = [("1x2x2", dict(data=1, model=2, pipe=2), {}),
                      ("2x2x1-fsdp", dict(data=2, model=2, pipe=1),
                       {"fsdp": True}),
                      ("2x2x1-sp-ring-fsdp", dict(data=2, model=2, pipe=1),
                       dict(SP_RING, fsdp=True))]


@functools.lru_cache(maxsize=None)
def _one_process(base: str):
    """The port's one process, two steps: every layout's oracle (once a
    test process), and the weights after its first step. GradCache's has
    no mesh to gather over."""
    kw = dict(LOSSES[base])
    if kw.get("grad_cache"):
        kw["global_negatives"] = False
    cfg = W.train_config(**kw)
    t = engine.Trainer(cfg, W.initial_state(31), device="cpu")
    batch = W.make_batch(32, cfg.loss_type)
    metrics, first = [], None
    for s in range(2):
        metrics.append({k: float(v) for k, v in t.train_step(batch).items()})
        if s == 0:
            first = W.numpy_state(t.model_state())
    return metrics, W.numpy_state(t.state_dict()), first


def _off_share(got_first, want_first):
    """The share of the first update's elements more than 2e-3 of their
    tensor's largest update (+ 1e-6) from ``want_first``'s."""
    initial = W.numpy_state(W.initial_state(31))
    off = total = 0
    for k, w in want_first.items():
        upd, got_upd = w - initial[k], got_first[k] - initial[k]
        off += int((np.abs(got_upd - upd)
                    > 2e-3 * np.abs(upd).max() + 1e-6).sum())
        total += upd.size
    return off / total


def _check_int8(got, got_first, want, want_first, what, floor=0.0):
    """The quantized tests' element tolerances (module docstring); the
    off share over ``floor``, the share at which the two packages' one
    process part already."""
    for k in want[0]:
        np.testing.assert_allclose(
            got[0][k], want[0][k], rtol=1e-4 if k == "grad_norm" else 2e-5,
            atol=1e-6, err_msg=f"{what}: step 0 {k}")
    for g, w in zip(got[1:], want[1:]):
        for k in ("total_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=5e-2,
                                       err_msg=f"{what}: {k}")
    share = _off_share(got_first, want_first)
    assert share <= floor + 1e-2, (what, share, floor)


def _world(mesh_kw):
    return mesh_kw["data"] * mesh_kw["model"] * mesh_kw["pipe"]


def _check_metrics(got, want, what, norm_rtol=1e-4):
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=norm_rtol if k == "grad_norm" else 1e-5,
            err_msg=f"{what}: {k}")


def _check_gates(ranks, cases):
    """``chip_smoke.py`` phase 11's comparisons
    (``perf/model_parallel_check.py::rank_modes``) at tiny width, two
    ranks: the port as it is within every ``MP_LIMITS`` gate (the sequence
    modes: ``SP_LIMITS``; the int8 modes: ``INT8_LIMITS``) of its
    one-process oracle; each fault of the trouble spots
    (``model_parallel_check.FAULTS``, ``sequence_parallel_check.FAULTS``)
    outside at least one."""
    smoke = _smoke()
    r0, r1 = (r["gates"] for r in ranks)
    for (fault, _, dtype), res0, res1 in zip(cases, r0, r1):
        for mode, res in res0.items():
            assert res1[mode]["metrics"] == res["metrics"], (fault, mode)
            limits = smoke.phase_11_limits(mode, dtype)
            vs = res["vs_oracle"]
            held = {k: (vs[k] >= lim if k.startswith("min_")
                        else vs[k] <= lim) for k, lim in limits.items()}
            if fault is None:
                assert all(held.values()), (mode, vs)
            else:
                assert not all(held.values()), (mode, fault, vs)


def _one_process_checkpoint(w1_dir):
    """Two steps of one process saving ``best/``: what every layout must
    restore bit for bit."""
    w1 = engine.Trainer(W.train_config(optimizer_type="adamspd",
                                       global_negatives=True, save_every=1),
                        W.initial_state(9), device="cpu",
                        checkpoint_manager=CheckpointManager(w1_dir))
    w1.train(lambda e: [{k: x.reshape((-1,) + x.shape[2:]) for k, x in
                         W.make_batch(20, "clip").items()}], 1, log_fn=None)
    return W.numpy_state(CheckpointManager(w1_dir).restore("best")[0])


def _check_checkpoints(ranks, root, w1_file):
    """A checkpoint written under TP x PP (or DP x TP with FSDP) is the
    replicated format: one process restores it bit for bit; one written
    by one process restores into the layout bit for bit; a resume on the
    layout is step-exact, and a preempt requested on rank 1 alone stops
    every rank at the same step."""
    for name, mesh_kw, extra in CHECKPOINT_LAYOUTS:
        r0 = ranks[0]["checkpoints"][name]
        assert all(np.isfinite(r0["losses"])), name
        state, meta = CheckpointManager(
            str(root / name / name)).restore("epoch_1")
        assert meta["config"]["mesh"] == mesh_kw
        saved = W.numpy_state(state)
        for r in ranks:
            r = r["checkpoints"][name]
            assert r["losses"] == r0["losses"], name
            assert_same_state(r["unbroken"], saved, name)
            assert_same_state(r["resumed"], saved, name)
            assert r["resumed_step"] == 4
            assert r["preempted"] and r["preempt_step"] == 2
            assert_same_state(r["w1_restored"], w1_file, name)
        one = engine.Trainer(W.train_config(optimizer_type="adamspd",
                                            global_negatives=True, **extra),
                             W.initial_state(7), device="cpu")
        one.load_state_dict(state)
        assert_same_state(W.numpy_state(one.state_dict()), saved, name)
        assert set(saved["model"]) == set(W.initial_state(0))


@pytest.mark.parametrize("group", list(GROUPS))
def test_layouts_match_jax_mesh_and_one_process(group, eight_devices,
                                                tmp_path):
    """TP, PP, the count loss under PP, GradCache under TP, switchback
    under PP, int8 under TP, PP, GradCache under TP, two data ranks and
    SP, SP (GSPMD, ring, the count loss), TP x PP, TP + ZeRO-1, TP +
    FSDP, PP + FSDP, a ring of four, SP + ZeRO-1, ring SP + FSDP and int8
    over data x model with FSDP, two steps each (the second reads
    AdamSPD's per-tensor sums of the first update, trouble spot b): every
    rank's metrics equal JAX's mesh step and the port's one process, the
    whole state every rank gathers is the same, and its weights are JAX's
    within JAX's own tolerances (int8: the element tolerances of the
    module docstring, against one process where GSPMD's semantics are one
    process's, against JAX's mesh step where given). Each rank holds
    its TP shards (H/tp heads) and its stage's layers only (SP: every
    parameter whole, its tokens' block of the activations). The same
    ranks then
    run phase 11's gates (two) or the checkpoints across layouts (four)."""
    cases = GROUPS[group]
    world = _world(cases[0][1])
    gate_args = checkpoint_args = pp_report_args = None
    if group == "two_ranks":
        pp_report_args = PP_REPORT_ARGS
    if world == 2:
        gate_args = (GATE_CASES[group], "tiny", None, 8, 2, 0, 3)
    else:
        w1_file = _one_process_checkpoint(str(tmp_path / "w1"))
        checkpoint_args = (CHECKPOINT_LAYOUTS, str(tmp_path / "ckpt"),
                           str(tmp_path / "w1"))
    # JAX's mesh steps compile in a thread while the ranks run; with int8
    # layouts also JAX's one device in int8.
    jax_out = {}

    def jax_steps():
        if any(base == "int8" and vs_jax for _, _, base, _, vs_jax in cases):
            jax_out["one device"] = jax_mp_steps(
                INT8, dict(data=1, model=1, pipe=1), 31, 32, eight_devices,
                2)
        for name, mesh_kw, base, extra, vs_jax in cases:
            if vs_jax:
                jax_out[name] = jax_mp_steps({**LOSSES[base], **extra},
                                             mesh_kw, 31, 32, eight_devices,
                                             2)
    thread = threading.Thread(target=jax_steps)
    thread.start()
    try:
        ranks = spawn(W.mp_group, world,
                      (([(mesh_kw, {**LOSSES[base], **extra})
                         for _, mesh_kw, base, extra, _ in cases], 31, 32,
                        2), gate_args, checkpoint_args, pp_report_args),
                      timeout_s=SPAWN_S)
    finally:
        thread.join()
    for i, (name, mesh_kw, base, extra, vs_jax) in enumerate(cases):
        assert name in jax_out or not vs_jax, name
        one, one_state, one_first = _one_process(base)
        for r in ranks:
            res = r["steps"][i]
            if "int8" in base:
                if vs_jax != "only":
                    _check_int8(res["metrics"], res["first"], one,
                                one_first, f"{name} vs one process")
                if vs_jax:
                    # With AdamSPD's anchors on the weights the first
                    # update is Adam's g / |g|, so an element whose
                    # gradient is near zero moves a whole step on rounding
                    # alone: the port's one process and JAX's one device
                    # part at ~1.5 % of the elements here (the JAX mesh
                    # steps from JAX's one device at 0.5-0.8 %), and a
                    # shard's scales at 15-45 %.
                    jax_metrics, _, jax_first = jax_out[name]
                    floor = _off_share(one_first, jax_out["one device"][2])
                    _check_int8(res["metrics"], res["first"], jax_metrics,
                                jax_first, f"{name} vs JAX", floor)
                assert np.isfinite(list(res["metrics"][-1].values())).all()
            elif base == "quant":
                _check_metrics(res["metrics"][0], one[0], name)
                for got, want in zip(res["metrics"][1:], one[1:]):
                    for k in ("total_loss", "grad_norm"):
                        np.testing.assert_allclose(got[k], want[k],
                                                   rtol=5e-2, err_msg=name)
                assert np.isfinite(list(res["metrics"][-1].values())).all()
            else:
                for got, want_one in zip(res["metrics"], one):
                    _check_metrics(got, want_one, f"{name} vs one process")
                assert_params_close(res["state"]["model"],
                                    one_state["model"], **JAX_PARAMS)
            if vs_jax and "int8" not in base:
                jax_metrics, jax_params, _ = jax_out[name]
                for got, want_jax in zip(res["metrics"], jax_metrics):
                    _check_metrics(got, want_jax, f"{name} vs JAX")
                assert_params_close(res["state"]["model"], jax_params,
                                    **JAX_PARAMS)
            assert_same_state(res["state"], ranks[0]["steps"][i]["state"],
                              name)
            d, m, p = res["coords"]
            shapes = res["shapes"]
            q = "vision_model.encoder.layers.{}.self_attn.q_proj.weight"
            layers = [j for j in range(2) if q.format(j) in shapes]
            assert layers == ([p] if mesh_kw["pipe"] == 2 else [0, 1]), name
            tp = 1 if extra.get("sequence_parallel") else mesh_kw["model"]
            if not extra.get("fsdp"):   # FSDP keeps no whole copy
                assert shapes[q.format(layers[0])] == (32 // tp, 32), name
        assert sorted(r["steps"][i]["coords"] for r in ranks) == sorted(
            (d, m, p) for d in range(mesh_kw["data"])
            for m in range(mesh_kw["model"])
            for p in range(mesh_kw["pipe"])), name
    if world == 2:
        _check_gates(ranks, GATE_CASES[group])
    else:
        _check_checkpoints(ranks, tmp_path / "ckpt", w1_file)
    if pp_report_args:
        _check_pp_report([r["pp_report"] for r in ranks])


# perf/pp_activation_report.py::rank_report at the tiny width in fp32:
# M 2 and 4 at B = 8, B 4 and 8 at b = 2, the unpipelined step at B = 8.
PP_REPORT_ARGS = ("cpu", "tiny", None, "float32", 8, (2, 4), ((4, 2), (8, 4)),
                  0)


def _check_pp_report(ranks):
    """Both stages report every swept (B, M), memory not measured on the
    CPU; at one B every pipelined step's loss is the unpipelined step's,
    the same on both stages."""
    _, _, _, _, fixed_B, micro, sweep, _ = PP_REPORT_ARGS
    runs = [(fixed_B, M) for M in micro] + list(sweep)
    for stage, rows in enumerate(ranks):
        piped = [r for r in rows if r["label"] != "unpipelined"]
        assert [(r["B"], r["M"]) for r in piped] == runs
        assert {r["stage"] for r in piped} == {stage}
        for r in rows:
            assert r["peak_memory_gb"] is None and r["step_gb"] is None
            assert np.isfinite(r["loss"])
    (single,) = [r for r in ranks[0] if r["label"] == "unpipelined"]
    assert single["B"] == fixed_B
    assert not any(r["label"] == "unpipelined" for r in ranks[1])
    for rows in ranks:
        for r in rows:
            if r["B"] == fixed_B:
                np.testing.assert_allclose(r["loss"], single["loss"],
                                           rtol=1e-5)
    for a, b in zip(ranks[0], ranks[1]):
        assert a["loss"] == b["loss"]


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    from clip_finegrained_alignment_tpu_torch.data.packed import pack_dataset
    from clip_finegrained_alignment_tpu_torch.data.synthetic import \
        generate_procedural_dataset
    from clip_finegrained_alignment_tpu_torch.data.tokenizer import \
        HashTokenizer
    root = tmp_path_factory.mktemp("mpcli")
    generate_procedural_dataset(str(root / "data"), 32, image_size=64,
                                max_objects=3, seed=4)
    pack_dataset(str(root / "data" / "synthetic_annotations.json"),
                 str(root / "packed"), mode="counterfactual", image_size=32,
                 context_length=16,
                 tokenizer=HashTokenizer(vocab_size=256, bos_token_id=254,
                                         eos_token_id=255, pad_token_id=0))
    return str(root / "packed")


def test_cli_tp_pp_on_four_ranks_then_resume_in_one(packed, tmp_path,
                                                     monkeypatch):
    """``cli/train.py --global-negatives --eval-every-epoch`` with the
    count loss on 4 gloo ranks, three runs on the same ranks:
    ``--model-parallel 2 --pipeline-parallel 2`` (one data rank: every
    rank reads the same rows), ``--fsdp`` (four data ranks) and
    ``--sequence-parallel 2 --sp-ring --fsdp`` (two data ranks of two
    sequence ranks). Each one's evaluation runs on the model every rank
    holds or gathers whole, so rank 0's accuracies are one process's
    ``evaluate_batch`` of the initial and the saved weights on rank 0's
    held-out batch; then a ``--resume`` by one process restores its
    ``best/`` bit for bit."""
    import json

    from clip_finegrained_alignment_tpu_torch.eval.batch_eval import \
        evaluate_batch
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
    args = ["--model", "tiny", "--loss-type", "count", "--optimizer",
            "adamspd", "--batch-size", "8", "--grad-accum", "2",
            "--save-every", "1", "--lr", "1e-3", "--no-amp",
            "--checkpoint-dir", str(tmp_path), "--device", "cpu",
            "--packed", packed, "--device-data", "--global-negatives"]
    runs = {"tp_pp": (["--model-parallel", "2", "--pipeline-parallel", "2",
                       "--pipeline-microbatches", "2"],
                      {"data": 1, "model": 2, "pipe": 2}),
            "fsdp": (["--fsdp"], {"data": 4, "model": 1, "pipe": 1}),
            "sp_ring_fsdp": (["--sequence-parallel", "2", "--sp-ring",
                              "--fsdp"], {"data": 2, "model": 2, "pipe": 1})}

    def run_args(name):
        return args + ["--experiment-name", name] + runs[name][0]
    metrics = {name: str(tmp_path / f"{name}.jsonl") for name in runs}
    argvs = [run_args(name) + ["--eval-every-epoch", "--metrics-file",
                               metrics[name], "--epochs", "1"]
             for name in runs]
    ranks = spawn(W.cli_mains, 4, ("clip_finegrained_alignment_tpu_torch."
                                   "cli.train", argvs), timeout_s=SPAWN_S)
    load = engine.Trainer.load_state_dict
    for i, (name, (_, mesh)) in enumerate(runs.items()):
        r0 = ranks[0][i]
        assert r0["global_step"] == 32 // 16, name
        assert np.isfinite(r0["losses"]).all(), name
        exp = tmp_path / name
        best, meta = CheckpointManager(str(exp)).restore("best")
        assert meta["config"]["mesh"] == mesh, name
        for r in ranks:
            assert r[i]["losses"] == r0["losses"], name
            assert_same_state(r[i]["state"], W.numpy_state(best), name)
        with open(metrics[name]) as f:
            evals = [(row["step"], row["count_eval_accuracy"])
                     for row in map(json.loads, f)
                     if "count_eval_accuracy" in row]
        assert [s for s, _ in evals] == [0, r0["global_step"]], name
        for png in ("confusion_pretrain.png", "confusion_epoch_0.png"):
            assert (exp / png).stat().st_size > 0, name
        restored = {}

        def spy(self, state):
            load(self, state)
            restored.update(W.numpy_state(self.state_dict()))
        monkeypatch.setattr(engine.Trainer, "load_state_dict", spy)
        out = cli_train.main(args + ["--experiment-name", name, "--resume",
                                     "--epochs", "2"])
        assert out["resumed_at_step"] == r0["global_step"], name
        assert_same_state(restored, W.numpy_state(best), name)
        assert out["trainer"].global_step == 2 * r0["global_step"], name
        # Rank 0's held-out batch, evaluated by one process on the weights
        # the ranks held or gathered.
        cfg = out["trainer"].cfg.model_config()
        initial = state_dict_from_jax(
            random_params(cfg, meta["config"]["seed"]), cfg)
        held = r0["first_batch"]
        for (_, acc), weights in zip(evals, (initial, best["model"])):
            assert evaluate_batch(weights, cfg, held,
                                  device="cpu")[0] == acc, name


def _smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke
