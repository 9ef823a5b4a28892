"""The port's train step (``clip_finegrained_alignment_tpu_torch/train/
engine.py``) against the JAX package's ``make_train_step(..., mesh=None)``
with its Pallas kernels on (``use_pallas_attention``, ``use_fused_sparc``;
interpret mode on the CPU).

Three steps of ``CLIPConfig.tiny_test()`` in fp32, microbatch 4 × accum 2,
lr 1e-3, for sparc + AdamSPD, clip + AdamW, count + AdamSPD (with
``cf_input_ids``) and clip_count + AdamW (with ``group_input_ids``), from
the same numpy weights and batches. The sparc and count cases feed uint8
pixels (the on-device normalize), some captions end in padding (SPARC's
mask), and
AdamSPD's anchors sit off the initial weights, so that the sign of
−⟨g, p − pre⟩ is well away from zero on every tensor.

Tolerances: losses rtol 2e-5 and ``grad_norm`` rtol 1e-4 (fp32 on both
sides, other summation orders); each parameter's update within 2e-3 of
the largest update of its tensor plus 1e-6. The updates are ~1e-3. Adam
divides the moment by its square root, so an element whose gradient is
near zero moves by a rounding-sensitive amount: the key projections'
biases have a zero gradient up to rounding (softmax ignores a constant
added to a row's scores) and move by ~1e-7 of noise on either side.

The quantized steps (``quant`` ``switchback`` and ``int8``, sparc and
count, fp32, two seeds read) hold the first step's losses and
``grad_norm`` to the same tolerances: its int8 GEMMs see the same
operands on both sides and read within 7.2e-6 of JAX's (the quantized
path moves the first loss 1.3e-4 to 3e-2 away from the exact path's, so
a GEMM left exact fails). Its update is held looser: Adam's first step is
~lr·sign(g), and torch's threaded CPU sums vary between runs, so a
gradient element near zero that one grid step of an int8 dgrad or wgrad
moves takes a whole lr: 0-169 of 51,329 elements (0.33 %) fell outside
the exact path's element tolerance, and at most 1 % may. After it,
quantization turns those differences into whole grid steps (and JAX's
jitted step divides each scale by 127 as a multiply by the reciprocal,
one ulp off IEEE division on ~4 % of rows): the second and third steps'
total loss and ``grad_norm`` read up to 1.1e-2 and 1.4e-2 relative (the
count loss's own term up to 5.3e-2), so those two are held within 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.config import \
    CLIPConfig as JaxCLIPConfig, TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.optim.factory import \
    make_optimizer as jax_make_optimizer
from clip_finegrained_alignment_tpu.train.engine import \
    make_train_step as jax_make_train_step
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig, TrainConfig
from clip_finegrained_alignment_tpu_torch.models import clip as tm
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.optim.factory import make_optimizer
from clip_finegrained_alignment_tpu_torch.train.engine import (Trainer,
                                                              make_train_step)

CFG = CLIPConfig.tiny_test()
JCFG = JaxCLIPConfig.tiny_test()
ACCUM, B, STEPS = 2, 4, 3


def _batch(loss_type, rng, uint8):
    v, t = CFG.vision, CFG.text
    T = t.max_position_embeddings
    shape = (ACCUM, B, v.image_size, v.image_size, 3)
    pix = (rng.integers(0, 256, size=shape).astype(np.uint8) if uint8
           else rng.normal(size=shape).astype(np.float32))

    def ids(*lead):
        x = rng.integers(1, t.bos_token_id - 1,
                         size=lead + (T,)).astype(np.int32)
        x[..., -1] = t.eos_token_id
        return x

    input_ids = ids(ACCUM, B)
    input_ids[:, 0, T - 5] = t.eos_token_id     # a caption ending in padding
    input_ids[:, 0, T - 4:] = t.pad_token_id
    batch = {"pixel_values": pix, "input_ids": input_ids}
    if loss_type == "count":
        batch["cf_input_ids"] = ids(ACCUM, B, 3)
    if loss_type == "clip_count":
        batch["group_input_ids"] = ids(ACCUM, B, 2)
    return batch


CASES = [("sparc", "adamspd"), ("clip", "adamw"), ("count", "adamspd"),
         ("clip_count", "adamw")]


@pytest.mark.parametrize("loss_type,optimizer_type", CASES)
def test_train_steps_match_jax(loss_type, optimizer_type):
    seed = CASES.index((loss_type, optimizer_type))
    kw = dict(batch_size=B,
              gradient_accumulation_steps=ACCUM, lr=1e-3, use_amp=False,
              loss_type=loss_type, optimizer_type=optimizer_type,
              inverse_temperature=0.07 if loss_type == "sparc" else 1.0)
    jcfg = JaxTrainConfig(**kw, clip_model="tiny", warmup_steps=0, remat=False,
                          use_pallas_attention=True, use_fused_sparc=True)
    cfg = TrainConfig(**kw)
    params = random_params(CFG, seed)
    rng = np.random.default_rng(seed)
    anchors = jax.tree.map(
        lambda p: p + rng.normal(scale=0.02, size=p.shape).astype(np.float32),
        params)

    # jnp.array copies: the jitted step donates its params, and a donated
    # buffer that aliased ``params`` would be overwritten in place.
    jp = jax.tree.map(jnp.array, params)
    jopt = jax_make_optimizer(jcfg, jp, anchor_params=jax.tree.map(
        jnp.array, anchors) if optimizer_type == "adamspd" else None)
    jstate = jopt.init(jp)
    jstep = jax_make_train_step(jcfg, JCFG, jopt, mesh=None)

    model = tm.build_train_model(CFG, state_dict_from_jax(params, CFG),
                                 device="cpu")
    opt = make_optimizer(cfg, model.named_parameters(),
                         anchors=state_dict_from_jax(anchors, CFG)
                         if optimizer_type == "adamspd" else None)
    step = make_train_step(cfg, CFG, model, opt)

    _build.reset_launch_counts()
    initial = state_dict_from_jax(params, CFG)
    before = {k: x.clone() for k, x in model.state_dict().items()}
    jbefore = {k: x.clone() for k, x in initial.items()}
    for i in range(STEPS):
        batch = _batch(loss_type, rng, uint8=loss_type in ("sparc", "count"))
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(x) for k, x in batch.items()})
        m = step(batch)
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(
                m[k].item(), float(jm[k]),
                rtol=1e-4 if k == "grad_norm" else 2e-5, atol=1e-6,
                err_msg=f"step {i} {k}")
        after = {k: x.clone() for k, x in model.state_dict().items()}
        jafter = {k: x.clone()
                  for k, x in state_dict_from_jax(jp, CFG).items()}
        for k in after:
            got = (after[k] - before[k]).numpy()
            want = (jafter[k] - jbefore[k]).numpy()
            tol = 2e-3 * np.abs(want).max() + 1e-6
            assert np.abs(got - want).max() <= tol, \
                f"step {i} {k}: update err {np.abs(got - want).max()} > {tol}"
        before, jbefore = after, jafter
    # Every parameter moved but those without a gradient under AdamSPD
    # (SPARC reads neither the vision post-LayerNorm nor logit_scale);
    # AdamW decays those too.
    still = {k for k in before if torch.equal(before[k], initial[k])}
    assert still <= {"logit_scale", "vision_model.post_layernorm.weight",
                     "vision_model.post_layernorm.bias"}
    assert optimizer_type == "adamspd" or not still
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert not any(_build.launch_counts().values())


def _steps_vs_jax(loss_type, quant, seed):
    """STEPS steps of both packages from the same weights, anchors and
    batches: per step (port metrics, JAX metrics, port update, JAX
    update)."""
    kw = dict(batch_size=B, gradient_accumulation_steps=ACCUM, lr=1e-3,
              use_amp=False, loss_type=loss_type, optimizer_type="adamspd",
              inverse_temperature=0.07 if loss_type == "sparc" else 1.0,
              quant=quant)
    jcfg = JaxTrainConfig(**kw, clip_model="tiny", warmup_steps=0,
                          remat=False, use_pallas_attention=True,
                          use_fused_sparc=True)
    params = random_params(CFG, seed)
    rng = np.random.default_rng(seed)
    anchors = jax.tree.map(
        lambda p: p + rng.normal(scale=0.02, size=p.shape).astype(np.float32),
        params)
    jp = jax.tree.map(jnp.array, params)
    jopt = jax_make_optimizer(jcfg, jp, anchor_params=jax.tree.map(
        jnp.array, anchors))
    jstate = jopt.init(jp)
    jstep = jax_make_train_step(jcfg, JCFG, jopt, mesh=None)
    cfg = TrainConfig(**kw)
    model = tm.build_train_model(CFG, state_dict_from_jax(params, CFG),
                                 device="cpu")
    step = make_train_step(cfg, CFG, model, make_optimizer(
        cfg, model.named_parameters(),
        anchors=state_dict_from_jax(anchors, CFG)))
    before = {k: x.clone() for k, x in model.state_dict().items()}
    jbefore = state_dict_from_jax(params, CFG)
    out = []
    for _ in range(STEPS):
        batch = _batch(loss_type, rng, uint8=True)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(x) for k, x in batch.items()})
        m = {k: x.item() for k, x in step(batch).items()}
        after = {k: x.clone() for k, x in model.state_dict().items()}
        jafter = state_dict_from_jax(jp, CFG)
        out.append((m, {k: float(x) for k, x in jm.items()},
                    {k: (after[k] - before[k]).numpy() for k in after},
                    {k: (jafter[k] - jbefore[k]).numpy() for k in after}))
        before, jbefore = after, jafter
    return out


@pytest.mark.parametrize("quant", ["switchback", "int8"])
@pytest.mark.parametrize("loss_type", ["sparc", "count"])
def test_quantized_train_steps_match_jax(loss_type, quant):
    """fp32 steps with int8 GEMMs, port against JAX (module docstring's
    tolerances: the first step as the exact path's, the later within
    2e-2)."""
    steps = _steps_vs_jax(loss_type, quant, seed=5)
    for i, (m, jm, upd, jupd) in enumerate(steps):
        assert sorted(m) == sorted(jm)
        assert all(np.isfinite(list(m.values())))
        if i > 0:
            for k in ("total_loss", "grad_norm"):
                np.testing.assert_allclose(m[k], jm[k], rtol=5e-2,
                                           err_msg=f"step {i} {k}")
            continue
        for k in jm:
            rtol = 1e-4 if k == "grad_norm" else 2e-5
            np.testing.assert_allclose(m[k], jm[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"step 0 {k}")
        bad = sum(int((np.abs(upd[k] - w) > 2e-3 * np.abs(w).max() + 1e-6)
                      .sum()) for k, w in jupd.items())
        assert bad <= 1e-2 * sum(w.size for w in jupd.values())


@pytest.mark.parametrize("quant", ["switchback", "int8"])
def test_quant_trajectory_tracks_exact(quant):
    """The port's mirror of JAX's ``test_quant_trajectory_tracks_bf16``:
    six SPARC + AdamSPD steps of the port's ``Trainer`` on one fixed batch
    (tiny model, fp32, 8 x 2) with int8 GEMMs: finite, decreasing, and
    within JAX's bound of the exact path's losses at every step."""
    def run(q):
        cfg = TrainConfig(clip_model="tiny", batch_size=8,
                          gradient_accumulation_steps=2, lr=1e-3,
                          use_amp=False, max_epochs=1, log_every=1000,
                          warmup_steps=0, loss_type="sparc",
                          inverse_temperature=0.07, optimizer_type="adamspd",
                          quant=q)
        trainer = Trainer(cfg, device="cpu")
        rng = np.random.default_rng(7)
        v, t = CFG.vision, CFG.text
        ids = rng.integers(1, t.vocab_size - 2,
                           size=(16, t.max_position_embeddings)
                           ).astype(np.int32)
        ids[:, -1] = t.eos_token_id
        batch = {"pixel_values": rng.normal(
            size=(16, v.image_size, v.image_size, 3)).astype(np.float32),
            "input_ids": ids}
        return [trainer.step(batch)["total_loss"].item() for _ in range(6)]

    exact, quantized = run("none"), run(quant)
    assert all(np.isfinite(quantized))
    assert quantized[-1] < quantized[0]
    for e, q in zip(exact, quantized):
        assert abs(q - e) < 0.25 * abs(e) + 0.05


def test_bf16_step_runs_on_cpu_near_the_fp32_step():
    """The bf16 compute path (plain versions on bf16 tensors): one SPARC
    step's loss within 2 % of the fp32 step's, finite gradient norm."""
    losses = {}
    for amp in (False, True):
        cfg = TrainConfig(batch_size=B,
                          gradient_accumulation_steps=ACCUM, lr=1e-3,
                          use_amp=amp, loss_type="sparc",
                          optimizer_type="adamspd", inverse_temperature=0.07)
        model = tm.build_train_model(
            CFG, state_dict_from_jax(random_params(CFG, 0), CFG),
            device="cpu")
        step = make_train_step(cfg, CFG, model,
                               make_optimizer(cfg, model.named_parameters()))
        m = step(_batch("sparc", np.random.default_rng(0), uint8=False))
        assert np.isfinite(m["grad_norm"].item())
        losses[amp] = m["total_loss"].item()
    np.testing.assert_allclose(losses[True], losses[False], rtol=2e-2)


def test_train_model_keeps_fp32_master_weights():
    model = tm.build_train_model(
        CFG, state_dict_from_jax(random_params(CFG, 0), CFG), device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    assert model.training
