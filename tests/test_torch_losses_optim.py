"""The port's objectives, optimizers, precision policy, train config and
FLOP counts against the JAX package's, on the same numpy inputs.

Tolerances:

* loss values: rtol 1e-5 (fp32 on both sides; they differ only in
  summation order);
* loss gradients: atol 1e-6 on gradients of size ≤ ~1 (same reason;
  JAX runs at "highest" matmul precision, ``tests/conftest.py``);
* optimizer trajectories: rtol 1e-5, atol 1e-6 on parameters of size
  ~1 after 6 steps of lr 1e-2 (the two sides round the moment updates
  and the bias corrections at other places, ~1e-7 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_finegrained_alignment_tpu.config import \
    CLIPConfig as JaxCLIPConfig, TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.core import precision as jprec
from clip_finegrained_alignment_tpu.objectives import losses as JL
from clip_finegrained_alignment_tpu.optim.factory import \
    make_optimizer as jax_make_optimizer
from clip_finegrained_alignment_tpu.utils import flops as jflops
from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                         PrecisionConfig,
                                                         TrainConfig)
from clip_finegrained_alignment_tpu_torch.core import precision as tprec
from clip_finegrained_alignment_tpu_torch.objectives import losses as TL
from clip_finegrained_alignment_tpu_torch.optim.adamspd import AdamSPD
from clip_finegrained_alignment_tpu_torch.optim.factory import (
    decay_mask, global_norm, make_optimizer)
from clip_finegrained_alignment_tpu_torch.utils import flops as tflops


def _t(x, requires_grad=True):
    return torch.tensor(np.asarray(x), dtype=torch.float32,
                        requires_grad=requires_grad)


def _sparc_inputs(rng, B=3, P=10, T=7, D=12):
    v = rng.normal(size=(B, P, D)).astype(np.float32)
    l = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, T // 2:] = 0.0        # a partly padded sample
    mask[2, 1] = 0.0
    return v, l, mask


def _loss_case(name, rng):
    """(jax loss fn, torch loss fn, list of differentiable numpy inputs)."""
    if name == "clip":
        x = [rng.normal(size=(6, 8)).astype(np.float32) for _ in range(2)]
        return (lambda a, b: JL.clip_loss(a, b)["total_loss"],
                lambda a, b: TL.clip_loss(a, b)["total_loss"], x)
    if name == "clip_count_groups":
        x = [rng.normal(size=s).astype(np.float32)
             for s in ((3, 8), (6, 8), (6, 4, 8))]
        return (lambda a, b, c: JL.clip_count_loss(
                    a, b, c, count_alpha=0.7)["total_loss"],
                lambda a, b, c: TL.clip_count_loss(
                    a, b, c, count_alpha=0.7)["total_loss"], x)
    if name == "clip_count_degenerate":
        x = [rng.normal(size=s).astype(np.float32) for s in ((4, 8), (4, 8))]
        return (lambda a, b: JL.clip_count_loss(a, b)["total_loss"],
                lambda a, b: TL.clip_count_loss(a, b)["total_loss"], x)
    if name == "count":
        x = [rng.normal(size=s).astype(np.float32)
             for s in ((5, 5), (5, 5), (5, 8), (5, 8), (5, 3, 8))]
        return (lambda *a: JL.count_loss(*a, alpha=0.9)["total_loss"],
                lambda *a: TL.count_loss(*a, alpha=0.9)["total_loss"], x)
    if name.startswith("sparc"):
        v, l, mask = _sparc_inputs(rng)
        if name == "sparc_masked_row":
            mask[1, :] = 0.0          # a fully masked sample
        tau = 0.0 if name == "sparc_tau0" else 0.5
        kw = dict(similarity_threshold=tau, inverse_temperature=0.07,
                  global_loss_weight=0.8, local_loss_weight=1.3)
        return (lambda a, b: JL.sparc_loss(a, b, jnp.asarray(mask),
                                           **kw)["total_loss"],
                lambda a, b: TL.sparc_loss(a, b, torch.from_numpy(mask),
                                           **kw)["total_loss"], [v, l])
    if name == "masked_pairwise":
        a, b, mask = _sparc_inputs(rng, P=7)
        mask[1, :] = 0.0
        return (lambda x, y: JL.masked_pairwise_contrastive_loss(
                    x, y, jnp.asarray(mask), 0.07),
                lambda x, y: TL.masked_pairwise_contrastive_loss(
                    x, y, torch.from_numpy(mask), 0.07), [a, b])
    raise ValueError(name)


LOSSES = ["clip", "clip_count_groups", "clip_count_degenerate", "count",
          "sparc", "sparc_masked_row", "sparc_tau0", "masked_pairwise"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_value_and_grads_match_jax(name):
    rng = np.random.default_rng(LOSSES.index(name))
    jfn, tfn, inputs = _loss_case(name, rng)
    argnums = tuple(range(len(inputs)))
    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=argnums))(
        *(jnp.asarray(x) for x in inputs))
    targs = [_t(x) for x in inputs]
    tval = tfn(*targs)
    tgrads = torch.autograd.grad(tval, targs)
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    for g, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)


def test_sparc_loss_dict_matches_jax():
    rng = np.random.default_rng(11)
    v, l, mask = _sparc_inputs(rng)
    want = jax.jit(lambda a, b, c: JL.sparc_loss(a, b, c,
                                                 inverse_temperature=0.07))(
        jnp.asarray(v), jnp.asarray(l), jnp.asarray(mask))
    got = TL.sparc_loss(_t(v), _t(l), torch.from_numpy(mask),
                        inverse_temperature=0.07)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0])
def test_alignment_weights_match_jax(threshold):
    rng = np.random.default_rng(5)
    sim = np.tanh(rng.normal(size=(2, 6, 9))).astype(np.float32)
    mask = np.ones((2, 6), np.float32)
    mask[1, 3:] = 0.0
    want = JL.sparc_alignment_weights(jnp.asarray(sim), jnp.asarray(mask),
                                      threshold)
    got = TL.sparc_alignment_weights(torch.from_numpy(sim),
                                     torch.from_numpy(mask), threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# Optimizers: multi-step trajectories against make_optimizer's optax chain
# ---------------------------------------------------------------------------

SHAPES = {"a": {"kernel": (6, 5), "bias": (5,)},
          "ln": {"scale": (5,), "bias": (5,)},
          "emb": {"kernel": (4, 3)},
          "frozen": {"kernel": (3, 2)}}   # its torch .grad stays None


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _tree(shape_tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in shape_tree.items()}


OPTIMIZERS = [("adamspd", False), ("adamspd", True), ("adamw", False)]


@pytest.mark.parametrize("optimizer_type,amsgrad", OPTIMIZERS)
def test_optimizer_trajectory_matches_optax_chain(optimizer_type, amsgrad):
    rng = np.random.default_rng(7)
    params = _tree(SHAPES, lambda s: rng.normal(size=s).astype(np.float32))
    anchors = _tree(SHAPES, lambda s: rng.normal(
        scale=0.05, size=s).astype(np.float32))
    anchors = jax.tree.map(lambda p, a: p + a, params, anchors)
    kw = dict(lr=1e-2, weight_decay=0.2, betas=(0.9, 0.98), eps=5e-6,
              amsgrad=amsgrad, max_grad_norm=1.0,
              optimizer_type=optimizer_type)
    jopt = jax_make_optimizer(JaxTrainConfig(**kw), params,
                              anchor_params=jax.tree.map(jnp.asarray,
                                                         anchors))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)

    @jax.jit
    def jstep(p, state, g):
        updates, state = jopt.update(g, state, p)
        return optax.apply_updates(p, updates), state

    names = _flat(params)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for n, v in names.items()}
    opt = make_optimizer(TrainConfig(**kw), tparams.items(),
                         anchors={n: torch.from_numpy(v) for n, v in
                                  _flat(anchors).items()})
    clipped = unclipped = 0
    for step in range(6):
        # Alternate small and large gradients: the clip fires on some steps.
        scale = 0.05 if step % 2 else 2.0
        grads = _tree(SHAPES, lambda s: (scale * rng.normal(size=s))
                      .astype(np.float32))
        grads["frozen"]["kernel"] = np.zeros(SHAPES["frozen"]["kernel"],
                                             np.float32)
        norm = float(optax.global_norm(grads))
        clipped += norm >= 1.0
        unclipped += norm < 1.0
        jp, jstate = jstep(jp, jstate, jax.tree.map(jnp.asarray, grads))

        opt.zero_grad()
        for n, g in _flat(grads).items():
            if not n.startswith("frozen"):
                tparams[n].grad = torch.from_numpy(g.copy())
        got_norm = opt.step()
        np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-6)
        for n, want in _flat(jax.tree.map(np.asarray, jp)).items():
            np.testing.assert_allclose(tparams[n].detach().numpy(), want,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {n}")
    assert clipped and unclipped
    if optimizer_type == "adamw":
        # The parameter without a gradient decayed, as its optax leaf did.
        assert not np.allclose(tparams["frozen.kernel"].detach().numpy(),
                               params["frozen"]["kernel"])


def test_adamspd_projects_only_when_the_gradient_points_away():
    """Step 1 moves away from the anchor with −⟨g, p − pre⟩ > 0: plain
    Adam. Step 2's gradient gives −⟨g, p − pre⟩ < 0 while momentum still
    moves away: the projection pulls the result toward the anchor."""
    anchor = torch.tensor([0.0, 0.0])
    p_spd = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    p_adam = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    spd = AdamSPD([p_spd], lr=0.1, weight_decay=1.0, anchors=[anchor])
    adam = AdamSPD([p_adam], lr=0.1, weight_decay=0.0, anchors=[anchor])
    for i, g in enumerate(([-1.0, -1.0], [0.1, 0.1])):
        for p, opt in ((p_spd, spd), (p_adam, adam)):
            p.grad = torch.tensor(g)
            opt.step()
        if i == 0:
            torch.testing.assert_close(p_spd.detach(), p_adam.detach())
    assert (p_spd.detach() - anchor).norm() < (p_adam.detach() - anchor).norm()
    # The curr == 0 guard: a step that lands on the anchor stays finite.
    r = torch.nn.Parameter(torch.tensor([0.0]))
    guard = AdamSPD([r], lr=0.0, weight_decay=1.0, anchors=[anchor[:1]])
    r.grad = torch.tensor([1.0])
    guard.step()
    assert r.item() == 0.0


def test_decay_mask_exempts_exactly_the_biases():
    from clip_finegrained_alignment_tpu_torch.models import clip as tm
    model = tm.CLIPModel(CLIPConfig.tiny_test())
    mask = decay_mask(n for n, _ in model.named_parameters())
    exempt = sorted(n for n, keep in mask.items() if not keep)
    assert exempt == sorted(n for n, _ in model.named_parameters()
                            if n.endswith(".bias"))
    assert mask["vision_model.pre_layrnorm.weight"]   # LN scales decay
    assert mask["logit_scale"]


def test_global_norm_matches_optax():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), ())]
    np.testing.assert_allclose(
        global_norm([torch.from_numpy(np.asarray(x)) for x in xs]).item(),
        float(optax.global_norm([jnp.asarray(x) for x in xs])), rtol=1e-6)


# ---------------------------------------------------------------------------
# Config, precision, FLOP counts
# ---------------------------------------------------------------------------

def test_train_config_defaults_match_jax():
    ours, theirs = TrainConfig(), JaxTrainConfig()
    for f in ("lr", "batch_size", "max_grad_norm",
              "weight_decay", "use_amp",
              "gradient_accumulation_steps", "loss_type",
              "similarity_threshold", "global_loss_weight",
              "local_loss_weight", "inverse_temperature", "optimizer_type",
              "betas", "eps", "amsgrad", "count_alpha", "seed"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.precision == PrecisionConfig()
    assert ours.precision.compute_dtype == theirs.precision.compute_dtype
    with pytest.raises(ValueError):
        TrainConfig(loss_type="nope")


@pytest.mark.parametrize("use_amp", [True, False])
def test_precision_policy_matches_jax(use_amp):
    want = jprec.compute_dtype(JaxTrainConfig(use_amp=use_amp))
    got = tprec.compute_dtype(TrainConfig(use_amp=use_amp))
    assert str(got).split(".")[-1] == jnp.dtype(want).name
    assert tprec.param_dtype(PrecisionConfig()) == torch.float32
    with pytest.raises(ValueError):
        tprec.resolve_dtype("float7")


@pytest.mark.parametrize("name", ["ViT-B/16", "ViT-B/32", "tiny"])
def test_train_step_flops_match_jax(name):
    ours, theirs = CLIPConfig.from_name(name), JaxCLIPConfig.from_name(name)
    assert tflops.sparc_train_step_flops(ours, 256) == \
        jflops.sparc_train_step_flops(theirs, 256)
    assert tflops.count_train_step_flops(ours, 32) == \
        jflops.count_train_step_flops(theirs, 32)
