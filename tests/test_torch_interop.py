"""Reference interop of the port: the optimizer state in both directions
(``clip_finegrained_alignment_tpu_torch/optim/interop.py``), OpenAI
``clip``-package naming (``models/convert.py``), ``cli/export_checkpoint.py``
and ``cli/train.py --import-optimizer-state``, against the JAX package's
``optim/interop.py``, ``models/hf_import.py`` and ``models/hf_export.py``
and an HF ``transformers.CLIPModel`` built offline from a config.

Tolerances: the port's and JAX's optimizer states after the same updates
from the same weights, anchors and gradients: rtol 1e-5, atol 1e-7 (fp32
on both sides, other rounding of the same moment updates; the anchors and
the structure exactly). Every conversion (naming, export, import) is held
exactly: it only moves tensors.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.config import \
    CLIPConfig as JaxCLIPConfig, TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.models import hf_export as jax_export
from clip_finegrained_alignment_tpu.models import hf_import as jax_import
from clip_finegrained_alignment_tpu.optim import interop as jax_interop
from clip_finegrained_alignment_tpu.optim.factory import \
    make_optimizer as jax_make_optimizer
from clip_finegrained_alignment_tpu_torch.cli import export_checkpoint
from clip_finegrained_alignment_tpu_torch.cli import train as cli
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig, TrainConfig
from clip_finegrained_alignment_tpu_torch.models import clip as tm
from clip_finegrained_alignment_tpu_torch.models import convert
from clip_finegrained_alignment_tpu_torch.optim import interop
from clip_finegrained_alignment_tpu_torch.optim.factory import make_optimizer

CFG = CLIPConfig.tiny_test()
JCFG = JaxCLIPConfig.tiny_test()
HP = dict(lr=1e-2, betas=(0.9, 0.98), eps=5e-6, weight_decay=0.3)
STEPS = 3


def _asymmetric(cfg):
    """Towers of different depths: text 1 layer, vision 3."""
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_layers=1),
        vision=dataclasses.replace(cfg.vision, num_layers=3))


def _hf_model(cfg):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPConfig(
        projection_dim=cfg.projection_dim,
        text_config=dict(
            vocab_size=cfg.text.vocab_size, hidden_size=cfg.text.hidden_size,
            intermediate_size=cfg.text.intermediate_size,
            num_hidden_layers=cfg.text.num_layers,
            num_attention_heads=cfg.text.num_heads,
            max_position_embeddings=cfg.text.max_position_embeddings),
        vision_config=dict(
            image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size,
            hidden_size=cfg.vision.hidden_size,
            intermediate_size=cfg.vision.intermediate_size,
            num_hidden_layers=cfg.vision.num_layers,
            num_attention_heads=cfg.vision.num_heads))
    return transformers.CLIPModel(hf_cfg)


@pytest.mark.parametrize("shape", ["tiny", "asymmetric"])
def test_hf_named_parameter_order(shape):
    cfg, jcfg = CFG, JCFG
    if shape == "asymmetric":
        cfg, jcfg = _asymmetric(CFG), _asymmetric(JCFG)
    order = interop.hf_named_parameter_order(cfg)
    assert order == jax_interop.hf_named_parameter_order(jcfg)
    hf = _hf_model(cfg)
    assert order == [n for n, _ in hf.named_parameters()]
    # The port holds the same names and shapes, registered in its own order.
    ours = interop.port_parameter_order(cfg)
    assert ours != order and sorted(ours) == sorted(order)
    shapes = {n: tuple(p.shape) for n, p in hf.named_parameters()}
    with torch.device("meta"):
        port = tm.CLIPModel(cfg)
    assert {n: tuple(p.shape) for n, p in port.named_parameters()} == shapes


def test_adamw_groups_match_the_reference_filter():
    decay, no_decay = interop.adamw_group_orders(CFG)
    assert (decay, no_decay) == jax_interop.adamw_group_orders(JCFG)
    assert no_decay and all(n.endswith("bias") for n in no_decay)


# ---------------------------------------------------------------------------
# The same updates in both packages
# ---------------------------------------------------------------------------

def _noise(rng, p):
    """A gradient-like array of ``p``'s shape (0-d included)."""
    return np.asarray(0.1 * rng.standard_normal(tuple(p.shape)),
                      dtype=np.float32)


def _trained(optimizer_type, amsgrad, seed):
    """``STEPS`` updates of the port's and of JAX's optimizer from the same
    weights, anchors and HF-named gradients: (port ClippedOptimizer, JAX
    opt_state, port model)."""
    rng = np.random.default_rng(seed)
    params = convert.random_params(CFG, seed)
    anchors = jax.tree.map(
        lambda p: p + rng.normal(scale=0.02, size=p.shape).astype(np.float32),
        params)
    kw = dict(optimizer_type=optimizer_type, amsgrad=amsgrad,
              max_grad_norm=0.0, **HP)
    model = tm.build_train_model(CFG, convert.state_dict_from_jax(params, CFG),
                                 device="cpu")
    opt = make_optimizer(TrainConfig(**kw), model.named_parameters(),
                         anchors=convert.state_dict_from_jax(anchors, CFG)
                         if optimizer_type == "adamspd" else None)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jax_make_optimizer(
        JaxTrainConfig(clip_model="tiny", **kw), jp,
        anchor_params=jax.tree.map(jnp.asarray, anchors)
        if optimizer_type == "adamspd" else None)
    jstate = jopt.init(jp)
    for _ in range(STEPS):
        g = {n: _noise(rng, p) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
        upd, jstate = jopt.update(jax_import.params_from_hf_state_dict(g, JCFG),
                                  jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
    return opt, jstate, model


def _assert_same(got, want, exact, path="sd"):
    """Structure (keys, lists, scalars) equal; tensors equal or within the
    header's tolerance."""
    if isinstance(want, dict):
        assert sorted(got, key=str) == sorted(want, key=str), path
        for k in want:
            _assert_same(got[k], want[k], exact, f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, exact, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype \
            and got.shape == want.shape, path
        if exact:
            assert torch.equal(got, want), path
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("amsgrad", [False, True])
def test_adamspd_export_equals_jax_and_round_trips(amsgrad):
    opt, jstate, _ = _trained("adamspd", amsgrad, seed=1 + amsgrad)
    state = opt.state_dict()
    sd = interop.reference_optimizer_state_dict(state, CFG, amsgrad=amsgrad,
                                                **HP)
    want = jax_interop.reference_optimizer_state_dict(jstate, JCFG,
                                                      amsgrad=amsgrad, **HP)
    _assert_same(sd, want, exact=False)
    assert all(e["step"] == STEPS for e in sd["state"].values())
    # Back into the port: the state it came from, exactly.
    groups = state["optimizer"]["param_groups"]
    _assert_same(interop.adamspd_state_from_reference(sd, CFG, groups),
                 state, exact=True)
    # JAX's export into the port and out again: JAX's, exactly.
    back = interop.adamspd_state_from_reference(want, CFG, groups)
    _assert_same(interop.reference_optimizer_state_dict(
        back, CFG, amsgrad=amsgrad, **HP), want, exact=True)


@pytest.mark.parametrize("pre", ["anchors", "none"])
@pytest.mark.parametrize("amsgrad", [False, True])
def test_adamspd_import_equals_jax(amsgrad, pre):
    """A reference state (JAX's export, its step an int or a 0-d tensor;
    ``pre=None``: the reference decays toward zeros) into the port equals
    JAX's import of it, mapped to HF names."""
    opt, jstate, _ = _trained("adamspd", amsgrad, seed=3 + amsgrad)
    ref = jax_interop.reference_optimizer_state_dict(jstate, JCFG,
                                                     amsgrad=amsgrad, **HP)
    if pre == "none":
        ref["param_groups"][0]["pre"] = None
        for e in ref["state"].values():      # newer torch: 0-d tensors
            e["step"] = torch.tensor(float(e["step"]))
    got = interop.adamspd_state_from_reference(
        ref, CFG, opt.state_dict()["optimizer"]["param_groups"])
    want = jax_interop.adamspd_state_from_reference(ref, JCFG)
    assert got["count"] == int(want.count) == STEPS
    names = interop.port_parameter_order(CFG)
    fields = {"anchor": want.anchor, "exp_avg": want.mu,
              "exp_avg_sq": want.nu}
    if amsgrad:
        fields["max_exp_avg_sq"] = want.nu_max
    for key, tree in fields.items():
        hf = convert.state_dict_from_jax(jax.tree.map(np.asarray, tree), CFG)
        for i, n in enumerate(names):
            assert torch.equal(got["optimizer"]["state"][i][key], hf[n]), \
                (key, n)
    if pre == "none":
        assert not any(e["anchor"].any()
                       for e in got["optimizer"]["state"].values())


def test_adamw_export_equals_jax_and_round_trips():
    opt, jstate, _ = _trained("adamw", False, seed=7)
    state = opt.state_dict()
    sd = interop.reference_adamw_optimizer_state_dict(state, CFG, **HP)
    want = jax_interop.reference_adamw_optimizer_state_dict(jstate, JCFG, **HP)
    _assert_same(sd, want, exact=False)
    groups = state["optimizer"]["param_groups"]
    _assert_same(interop.adamw_state_from_reference(sd, CFG, groups), state,
                 exact=True)
    back = interop.adamw_state_from_reference(want, CFG, groups)
    _assert_same(interop.reference_adamw_optimizer_state_dict(back, CFG, **HP),
                 want, exact=True)
    # The port's two groups come back in the port's order.
    assert [g["weight_decay"] for g in back["optimizer"]["param_groups"]] \
        == [HP["weight_decay"], 0.0]


def test_adamw_single_group_import_equals_jax():
    """Plain ``AdamW(model.parameters())``: one group, positions in HF
    registration order."""
    hf = _hf_model(CFG)
    ref_opt = torch.optim.AdamW(hf.parameters(), lr=HP["lr"],
                                betas=HP["betas"], eps=HP["eps"],
                                weight_decay=0.0)
    rng = np.random.default_rng(9)
    for _ in range(STEPS):
        for p in hf.parameters():
            p.grad = torch.from_numpy(_noise(rng, p))
        ref_opt.step()
    ref = ref_opt.state_dict()
    opt, _, _ = _trained("adamw", False, seed=9)
    got = interop.adamw_state_from_reference(
        ref, CFG, opt.state_dict()["optimizer"]["param_groups"])
    want = jax_interop.adamw_state_from_reference(ref, JCFG)
    assert got["count"] == int(want.count) == STEPS
    names = [n for g in interop._port_adamw_groups(CFG) for n in g]
    for key, tree in (("exp_avg", want.mu), ("exp_avg_sq", want.nu)):
        hf_sd = convert.state_dict_from_jax(jax.tree.map(np.asarray, tree),
                                            CFG)
        for i, n in enumerate(names):
            assert torch.equal(got["optimizer"]["state"][i][key], hf_sd[n])


def test_import_into_a_live_optimizer_continues_its_trajectory():
    """Export after k updates, import into a fresh optimizer, and the next
    updates equal those of the optimizer that never stopped."""
    for optimizer_type in ("adamspd", "adamw"):
        opt, _, model = _trained(optimizer_type, False, seed=13)
        export = interop.reference_optimizer_state_dict \
            if optimizer_type == "adamspd" \
            else interop.reference_adamw_optimizer_state_dict
        sd = export(opt.state_dict(), CFG, **HP)
        twin = tm.build_train_model(CFG, model.state_dict(), device="cpu")
        fresh = make_optimizer(
            TrainConfig(optimizer_type=optimizer_type, max_grad_norm=0.0,
                        **HP), twin.named_parameters())
        assert interop.load_reference_state(fresh, sd, CFG) == STEPS
        rng = np.random.default_rng(14)
        for _ in range(2):
            g = {n: torch.from_numpy(_noise(rng, p))
                 for n, p in model.named_parameters()}
            for m, o in ((model, opt), (twin, fresh)):
                for n, p in m.named_parameters():
                    p.grad = g[n].clone()
                o.step()
        for n, p in model.named_parameters():
            assert torch.equal(dict(twin.named_parameters())[n], p), n


# ---------------------------------------------------------------------------
# OpenAI naming
# ---------------------------------------------------------------------------

def test_openai_export_and_import_equal_jax():
    params = convert.random_params(CFG, 21)
    sd = convert.state_dict_from_jax(params, CFG)
    got = convert.openai_state_dict(sd, CFG)
    want = jax_export.openai_state_dict_from_params(params, JCFG)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert convert.is_openai_state_dict(got) and \
        jax_import.is_openai_state_dict(got)
    # OpenAI ships fp16 weights, DDP wraps names in "module.".
    half = {"module." + k: torch.from_numpy(v).half() for k, v in want.items()}
    back = convert.state_dict_from_openai(half, CFG)
    ref = convert.state_dict_from_jax(
        jax.tree.map(np.asarray,
                     jax_import.params_from_openai_state_dict(half, JCFG)),
        CFG)
    assert sorted(back) == sorted(ref) == sorted(sd)
    for k in ref:
        assert torch.equal(back[k], ref[k]), k
    # fp32 round trip through the port's own pair: exact.
    again = convert.state_dict_from_openai(got, CFG)
    assert all(torch.equal(again[k], v) for k, v in sd.items())


@pytest.mark.parametrize("fmt", ["hf", "openai"])
def test_reference_pt_both_ways_with_jax(tmp_path, fmt):
    params = convert.random_params(CFG, 22)
    sd = convert.state_dict_from_jax(params, CFG)
    ours = str(tmp_path / "ours.pt")
    convert.save_reference_checkpoint(ours, sd, CFG, global_step=5,
                                      best_loss=1.25, fmt=fmt)
    jparams, meta = jax_import.load_reference_checkpoint(ours, JCFG)
    assert meta["global_step"] == 5 and meta["best_loss"] == 1.25
    got = convert.state_dict_from_jax(jax.tree.map(np.asarray, jparams), CFG)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    theirs = str(tmp_path / "theirs.pt")
    jax_export.save_reference_checkpoint(theirs, params, JCFG, global_step=6,
                                         fmt=fmt)
    back, meta = convert.load_reference_checkpoint(theirs, CFG)
    assert meta["global_step"] == 6
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

SAMPLES, B, ACCUM = 32, 4, 2
SPE = SAMPLES // (B * ACCUM)


@pytest.fixture(autouse=True)
def hash_tokenizer(monkeypatch):
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    from clip_finegrained_alignment_tpu_torch.data.packed import pack_dataset
    from clip_finegrained_alignment_tpu_torch.data.synthetic import \
        generate_procedural_dataset
    from clip_finegrained_alignment_tpu_torch.data.tokenizer import \
        HashTokenizer
    root = tmp_path_factory.mktemp("interop")
    generate_procedural_dataset(str(root / "data"), SAMPLES, image_size=64,
                                max_objects=3, seed=4)
    pack_dataset(str(root / "data" / "synthetic_annotations.json"),
                 str(root / "packed"), image_size=32, context_length=16,
                 tokenizer=HashTokenizer(vocab_size=256, bos_token_id=254,
                                         eos_token_id=255, pad_token_id=0))
    return str(root / "packed")


def _args(ckpt, packed, optimizer, *extra, epochs=1):
    loss = "sparc" if optimizer == "adamspd" else "clip"
    return ["--model", "tiny", "--loss-type", loss, "--optimizer", optimizer,
            "--batch-size", str(B), "--grad-accum", str(ACCUM), "--epochs",
            str(epochs), "--save-every", "1", "--lr", "1e-3", "--no-amp",
            "--packed", packed, "--checkpoint-dir", str(ckpt), "--device",
            "cpu", "--log-every", "100", *extra]


@pytest.fixture(scope="module")
def trained(packed, tmp_path_factory):
    """One epoch of sparc + AdamSPD and of clip + AdamW: their best/."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
        for optimizer in ("adamspd", "adamw"):
            ckpt = tmp_path_factory.mktemp(optimizer)
            cli.main(_args(ckpt, packed, optimizer))
            out[optimizer] = ckpt / "clip_finetune" / "best"
    return out


def _export(best, path, *extra):
    return export_checkpoint.main(["--checkpoint", str(best), "--model",
                                   "tiny", "--output", str(path), *extra])


@pytest.mark.parametrize("optimizer", ["adamspd", "adamw"])
def test_export_checkpoint_loads_in_jax(trained, tmp_path, optimizer):
    best = trained[optimizer]
    state = torch.load(best / "state.pt", weights_only=True)
    with open(best / "meta.json") as f:
        meta = json.load(f)
    out = tmp_path / "best.pt"
    res = _export(best, out, "--include-optimizer")
    assert res["optimizer"] and res["global_step"] == meta["global_step"]
    params, jmeta = jax_import.load_reference_checkpoint(str(out), JCFG)
    got = convert.state_dict_from_jax(jax.tree.map(np.asarray, params), CFG)
    assert all(torch.equal(got[k], v) for k, v in state["model"].items())
    assert jmeta["global_step"] == meta["global_step"] == SPE
    assert jmeta["config"] == meta["config"]
    # JAX reads the optimizer state, and it carries the run's step.
    opt_sd = jmeta["optimizer_state_dict"]
    imported = jax_interop.adamspd_state_from_reference(opt_sd, JCFG) \
        if optimizer == "adamspd" \
        else jax_interop.adamw_state_from_reference(opt_sd, JCFG)
    assert int(imported.count) == SPE
    # The port reads it back with weights_only and restores best/'s
    # optimizer state exactly.
    sd, pmeta = convert.load_reference_checkpoint(str(out), CFG)
    trainer_opt = make_optimizer(
        TrainConfig.from_dict(meta["config"]),
        tm.build_train_model(CFG, sd, device="cpu").named_parameters())
    interop.load_reference_state(trainer_opt, pmeta["optimizer_state_dict"],
                                 CFG)
    _assert_same(trainer_opt.state_dict(), state["optimizer"], exact=True)


def test_export_checkpoint_openai_and_conversions(trained, tmp_path):
    best = trained["adamspd"]
    state = torch.load(best / "state.pt", weights_only=True)
    out = tmp_path / "openai.pt"
    _export(best, out, "--format", "openai", "--global-step", "99")
    ckpt = torch.load(out, weights_only=True)
    assert "visual.conv1.weight" in ckpt["model_state_dict"]
    assert ckpt["global_step"] == 99 and "optimizer_state_dict" not in ckpt
    sd, _ = convert.load_reference_checkpoint(str(out), CFG)
    assert all(torch.equal(sd[k], v) for k, v in state["model"].items())
    # A reference .pt converts back to HF names.
    hf = tmp_path / "hf.pt"
    _export(out, hf)
    back, meta = convert.load_reference_checkpoint(str(hf))
    assert meta["global_step"] == 99
    assert all(torch.equal(back[k], v) for k, v in state["model"].items())


@pytest.mark.parametrize("extra,message", [
    (["--format", "openai", "--include-optimizer"], "--format hf"),
    (["--include-optimizer"], "checkpoint directory"),
])
def test_export_checkpoint_refusals(trained, tmp_path, extra, message):
    src = trained["adamspd"]
    if "--format" not in extra:
        src = tmp_path / "plain.pt"
        _export(trained["adamspd"], src)
    with pytest.raises(SystemExit) as e:
        _export(src, tmp_path / "x.pt", *extra)
    assert message in str(e.value.code)


@pytest.mark.parametrize("optimizer", ["adamspd", "adamw"])
def test_import_optimizer_state_continues_like_resume(trained, packed,
                                                      tmp_path, optimizer,
                                                      capsys):
    """--pretrained x.pt --import-optimizer-state equals --resume of the
    best/ it was exported from, over the same next epoch."""
    best = trained[optimizer]
    pt = tmp_path / "best.pt"
    _export(best, pt, "--include-optimizer")
    imported = cli.main(_args(tmp_path / "imp", packed, optimizer,
                              "--pretrained", str(pt),
                              "--import-optimizer-state", epochs=2))
    assert imported["start_epoch"] == 1
    assert "imported reference optimizer state (step 4" in \
        capsys.readouterr().out
    resumed = cli.main(_args(tmp_path / "res", packed, optimizer, "--resume",
                             str(best), epochs=2))
    assert imported["trainer"].global_step == resumed["trainer"].global_step \
        == 2 * SPE
    assert [h["avg_loss"] for h in imported["history"]] == \
        [h["avg_loss"] for h in resumed["history"]]
    a, b = imported["trainer"], resumed["trainer"]
    assert a.best_loss == b.best_loss
    for k, v in b.model.state_dict().items():
        assert torch.equal(a.model.state_dict()[k], v), k


def test_import_optimizer_state_refusals(trained, packed, tmp_path):
    best = trained["adamspd"]
    full, bare = tmp_path / "full.pt", tmp_path / "bare.pt"
    _export(best, full, "--include-optimizer")
    _export(best, bare)
    cases = [
        (["--pretrained", str(full), "--import-optimizer-state", "--resume"],
         "pick one source"),
        (["--import-optimizer-state"], "requires --pretrained"),
        (["--pretrained", str(bare), "--import-optimizer-state"],
         "carries no optimizer_state_dict"),
        (["--pretrained", str(full), "--import-optimizer-state",
          "--amsgrad"], "amsgrad"),
    ]
    for extra, message in cases:
        with pytest.raises(SystemExit) as e:
            cli.main(_args(tmp_path / "ck", packed, "adamspd", *extra))
        assert message in str(e.value.code), extra
    with pytest.warns(UserWarning, match="hyperparameter drift.*lr"):
        cli.main(_args(tmp_path / "ck", packed, "adamspd", "--pretrained",
                       str(full), "--import-optimizer-state", "--lr", "2e-3",
                       epochs=1))
