"""The port's GradCache (``clip_finegrained_alignment_tpu_torch/train/
gradcache.py``) against its own direct full-pool step and against the JAX
package's ``gradcache_grads`` (Pallas kernels on, interpret mode on the
CPU), on ``CLIPConfig.tiny_test()`` in fp32.

Every test draws its data from its own ``np.random.default_rng(seed)``.

Tolerances:
* GradCache at [accum 4, B 4] against one direct [1, 16] step of the
  port: loss rtol 1e-6, gradients rtol 2e-5, atol 1e-7 (the JAX package's
  own pin, ``tests/test_gradcache.py``): the same math, the backward split
  at the embeddings.
* The port against JAX: losses rtol 2e-5, gradients rtol 1e-4, atol 1e-6
  (``tests/test_torch_train.py``'s convention: fp32 on both sides, other
  summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.config import \
    CLIPConfig as JaxCLIPConfig, TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.train.gradcache import \
    gradcache_grads as jax_gradcache_grads
from clip_finegrained_alignment_tpu_torch.cli import train as cli
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig, TrainConfig
from clip_finegrained_alignment_tpu_torch.models import clip as tm
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.optim.factory import make_optimizer
from clip_finegrained_alignment_tpu_torch.train import gradcache as gc
from clip_finegrained_alignment_tpu_torch.train.engine import (
    Trainer, accumulate_grads, make_train_step)

CFG = CLIPConfig.tiny_test()
JCFG = JaxCLIPConfig.tiny_test()
ACCUM, B = 4, 4


def _cfg(loss_type, accum=ACCUM, b=B, **kw):
    base = dict(batch_size=b, gradient_accumulation_steps=accum, lr=1e-3,
                use_amp=False, loss_type=loss_type, grad_cache=True,
                inverse_temperature=0.07 if loss_type == "sparc" else 1.0)
    base.update(kw)
    return TrainConfig(**base)


def _batch(seed, accum=ACCUM, b=B, uint8=False):
    rng = np.random.default_rng(seed)
    t, v = CFG.text, CFG.vision
    ids = rng.integers(1, t.bos_token_id - 1,
                       size=(accum, b, t.max_position_embeddings)
                       ).astype(np.int32)
    ids[..., -1] = t.eos_token_id
    # Padded captions in every chunk: SPARC's mask crosses the chunks.
    ids[:, 0, -5] = t.eos_token_id
    ids[:, 0, -4:] = t.pad_token_id
    shape = (accum, b, v.image_size, v.image_size, 3)
    pix = rng.integers(0, 256, size=shape).astype(np.uint8) if uint8 \
        else rng.normal(size=shape).astype(np.float32)
    return {"pixel_values": pix, "input_ids": ids}


def _model(seed):
    return tm.build_train_model(
        CFG, state_dict_from_jax(random_params(CFG, seed), CFG), device="cpu")


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _torch(batch):
    return {k: torch.from_numpy(x) for k, x in batch.items()}


def _assert_grads(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   rtol=rtol, atol=atol, err_msg=n)


@pytest.mark.parametrize("loss_type", ["clip", "sparc"])
def test_gradcache_equals_direct_full_pool_step(loss_type):
    seed = 11 + ["clip", "sparc"].index(loss_type)
    batch = _torch(_batch(seed, uint8=True))
    model = _model(seed)
    losses = gc.gradcache_grads(model, batch, _cfg(loss_type), CFG,
                                dtype=torch.float32)
    got = _grads(model)

    direct = _model(seed)
    flat = {k: x.reshape((1, ACCUM * B) + x.shape[2:])
            for k, x in batch.items()}
    want = accumulate_grads(direct, flat,
                            _cfg(loss_type, 1, ACCUM * B, grad_cache=False),
                            CFG, dtype=torch.float32)
    assert sorted(losses) == sorted(want)
    for k in want:
        np.testing.assert_allclose(losses[k].item(), want[k].item(),
                                   rtol=1e-6, err_msg=k)
    _assert_grads(got, _grads(direct), rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("loss_type", ["clip", "sparc"])
def test_gradcache_matches_jax(loss_type):
    seed = 21 + ["clip", "sparc"].index(loss_type)
    params = random_params(CFG, seed)
    batch = _batch(seed)
    jcfg = JaxTrainConfig(
        clip_model="tiny", batch_size=B, gradient_accumulation_steps=ACCUM,
        use_amp=False, loss_type=loss_type, grad_cache=True, remat=False,
        use_pallas_attention=True, use_fused_sparc=True,
        inverse_temperature=0.07 if loss_type == "sparc" else 1.0)
    jgrads, jlosses = jax.jit(
        lambda p, b: jax_gradcache_grads(p, b, jcfg, JCFG, jnp.float32))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(x) for k, x in batch.items()})

    model = tm.build_train_model(CFG, state_dict_from_jax(params, CFG),
                                 device="cpu")
    losses = gc.gradcache_grads(model, _torch(batch), _cfg(loss_type), CFG,
                                dtype=torch.float32)
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]),
                                   rtol=2e-5, err_msg=k)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), CFG)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in model.named_parameters()}
    _assert_grads(got, want, rtol=1e-4, atol=1e-6)


def test_full_pool_loss_differs_from_chunk_mean():
    batch = _torch(_batch(31))
    full = gc.gradcache_grads(_model(31), batch, _cfg("clip"), CFG,
                              dtype=torch.float32)
    chunked = accumulate_grads(_model(31), batch,
                               _cfg("clip", grad_cache=False), CFG,
                               dtype=torch.float32)
    # 16 negatives against 4: the softmax normalizer alone separates them.
    assert abs(full["total_loss"].item()
               - chunked["total_loss"].item()) > 1e-3


@pytest.mark.parametrize("loss_type", ["count", "clip_count"])
def test_count_losses_are_refused(loss_type):
    cfg = _cfg(loss_type)
    with pytest.raises(ValueError, match="grad_cache supports"):
        gc.validate_gradcache(cfg)
    model = _model(0)
    with pytest.raises(ValueError, match="grad_cache supports"):
        make_train_step(cfg, CFG, model,
                        make_optimizer(cfg, model.named_parameters()))


def test_pixel_bank_batch_equals_pixel_batch():
    rng = np.random.default_rng(41)
    pixels = _batch(41, uint8=True)["pixel_values"]
    bank = pixels.reshape((ACCUM * B,) + pixels.shape[2:])
    index = rng.permutation(ACCUM * B).reshape(ACCUM, B).astype(np.int32)
    ids = _batch(42)["input_ids"]
    cfg = _cfg("sparc")
    by_pixels = _model(41)
    gc.gradcache_grads(by_pixels, _torch({"pixel_values": bank[index],
                                          "input_ids": ids}), cfg, CFG,
                       dtype=torch.float32)
    by_index = _model(41)
    gc.gradcache_grads(by_index, _torch({"pixel_index": index,
                                         "input_ids": ids}), cfg, CFG,
                       dtype=torch.float32, pixel_bank=torch.from_numpy(bank))
    _assert_grads(_grads(by_index), _grads(by_pixels), rtol=0, atol=0)


def test_cache_and_cotangent_stay_in_the_compute_dtype(monkeypatch):
    """Under bf16 the cache leaf and its cotangent are bf16 (the JAX
    package differentiates at the cached embeddings in the compute
    dtype); the master gradients are fp32."""
    seen = {}
    loss_fn, grad_fn = gc._full_batch_loss, torch.autograd.grad

    def spy_loss(embs, *args):
        seen["cache"] = [(e.dtype, e.is_leaf, e.requires_grad) for e in embs]
        return loss_fn(embs, *args)

    def spy_grad(outputs, inputs, *args, **kw):
        out = grad_fn(outputs, inputs, *args, **kw)
        seen["cotangent"] = [g.dtype for g in out]
        return out

    monkeypatch.setattr(gc, "_full_batch_loss", spy_loss)
    monkeypatch.setattr(torch.autograd, "grad", spy_grad)
    model = _model(51)
    gc.gradcache_grads(model, _torch(_batch(51, accum=2, b=2)),
                       _cfg("sparc", 2, 2, use_amp=True), CFG,
                       dtype=torch.bfloat16)
    assert seen["cache"] == [(torch.bfloat16, True, True)] * 2
    assert seen["cotangent"] == [torch.bfloat16] * 2
    assert all(p.grad.dtype == torch.float32
               for p in model.parameters() if p.grad is not None)


@pytest.mark.parametrize("loss_type", ["clip", "sparc"])
def test_train_step_and_trainer_run_with_grad_cache(loss_type):
    seed = 61 + ["clip", "sparc"].index(loss_type)
    cfg = _cfg(loss_type, clip_model="tiny", optimizer_type="adamspd")
    batch = _batch(seed, uint8=True)
    model = _model(seed)
    step = make_train_step(cfg, CFG, model,
                           make_optimizer(cfg, model.named_parameters()))
    metrics = step(batch)
    # The step's loss is the full-pool one, not the chunk mean.
    want = gc.gradcache_grads(_model(seed), _torch(batch), cfg, CFG,
                              dtype=torch.float32)
    assert metrics["total_loss"].item() == want["total_loss"].item()
    assert np.isfinite(metrics["grad_norm"].item())

    trainer = Trainer(cfg, state_dict_from_jax(random_params(CFG, seed), CFG),
                      device="cpu")
    host = {k: x.reshape((ACCUM * B,) + x.shape[2:])
            for k, x in batch.items()}
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    m = trainer.step(host)
    assert m["total_loss"].item() == want["total_loss"].item()
    assert trainer.global_step == 1
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p, before[n])]
    assert "visual_projection.weight" in moved


def test_config_round_trips_grad_cache():
    cfg = dataclasses.replace(_cfg("sparc"), clip_model="tiny")
    assert TrainConfig.from_dict(cfg.to_dict()).grad_cache is True
    jd = JaxTrainConfig(clip_model="tiny", grad_cache=True,
                        loss_type="sparc")
    assert TrainConfig.from_dict(dataclasses.asdict(jd)).grad_cache is True


# ---------------------------------------------------------------------------
# cli/train.py --grad-cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    from clip_finegrained_alignment_tpu_torch.data.packed import pack_dataset
    from clip_finegrained_alignment_tpu_torch.data.synthetic import \
        generate_procedural_dataset
    from clip_finegrained_alignment_tpu_torch.data.tokenizer import \
        HashTokenizer
    root = tmp_path_factory.mktemp("gc_cli")
    generate_procedural_dataset(str(root / "data"), 32, image_size=64,
                                max_objects=3, seed=3)
    pack_dataset(str(root / "data" / "synthetic_annotations.json"),
                 str(root / "packed"), image_size=32, context_length=16,
                 tokenizer=HashTokenizer(vocab_size=256, bos_token_id=254,
                                         eos_token_id=255, pad_token_id=0))
    return str(root / "packed")


def _cli_args(ckpt, packed, loss_type):
    return ["--model", "tiny", "--loss-type", loss_type, "--optimizer",
            "adamspd", "--batch-size", "4", "--grad-accum", "4",
            "--epochs", "1", "--lr", "1e-3", "--no-amp", "--packed", packed,
            "--device-data", "--checkpoint-dir", str(ckpt), "--device",
            "cpu", "--grad-cache"]


def test_cli_grad_cache_one_epoch(packed, tmp_path, monkeypatch):
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
    calls = []
    real = gc.gradcache_grads

    def spy(*args, **kw):
        calls.append(args[1]["input_ids"].shape)
        return real(*args, **kw)

    monkeypatch.setattr(gc, "gradcache_grads", spy)
    res = cli.main(_cli_args(tmp_path, packed, "sparc"))
    assert res["trainer"].cfg.grad_cache and res["trainer"].global_step == 2
    assert calls == [(4, 4, 16)] * 2
    assert np.isfinite(res["history"][0]["avg_loss"])


@pytest.mark.parametrize("loss_type", ["count", "clip_count"])
def test_cli_grad_cache_refuses_count_losses(packed, tmp_path, monkeypatch,
                                             loss_type):
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
    with pytest.raises(SystemExit) as e:
        cli.main(_cli_args(tmp_path, packed, loss_type))
    assert "grad_cache supports" in str(e.value.code)


def test_fp32_gradcache_vs_direct_at_vit_b16_width():
    """ViT-B/16 widths, one layer a tower, fp32: GradCache [8, 4] against
    one direct [1, 32] step. ``chip_smoke.py``'s GC_F32_LIMITS for the
    card's full-depth check were set from this reading (loss 0, gradient
    norm 5.5e-10, cosine gap 3e-13; 1e-12 and 1.8e-12 at two and three
    layers): it stays 100x inside them."""
    import math
    cfg = CLIPConfig.vit_b16()
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_layers=1),
        text=dataclasses.replace(cfg.text, num_layers=1))
    sd = state_dict_from_jax(random_params(cfg, 0), cfg)
    rng = np.random.default_rng(71)
    a, b = 8, 4
    ids = rng.integers(1, cfg.text.vocab_size - 2, size=(a, b, 77))
    ids[..., -1] = cfg.text.eos_token_id
    batch = {"input_ids": torch.from_numpy(ids),
             "pixel_values": torch.from_numpy(rng.normal(
                 size=(a, b, 224, 224, 3)).astype(np.float32))}
    tc = TrainConfig(loss_type="sparc", inverse_temperature=0.07,
                     use_amp=False, batch_size=b,
                     gradient_accumulation_steps=a, grad_cache=True)
    side = {}
    for name in ("gradcache", "direct"):
        model = tm.build_train_model(cfg, sd, device="cpu")
        if name == "gradcache":
            losses = gc.gradcache_grads(model, batch, tc, cfg,
                                        dtype=torch.float32)
        else:
            flat = {k: x.reshape((1, a * b) + x.shape[2:])
                    for k, x in batch.items()}
            losses = accumulate_grads(
                model, flat, dataclasses.replace(
                    tc, grad_cache=False, batch_size=a * b,
                    gradient_accumulation_steps=1), cfg, dtype=torch.float32)
        grads = {n: p.grad.double() for n, p in model.named_parameters()
                 if p.grad is not None}
        side[name] = (losses["total_loss"].item(), math.sqrt(sum(
            g.square().sum().item() for g in grads.values())), grads)
    (l1, n1, g1), (l2, n2, g2) = side["gradcache"], side["direct"]
    assert abs(l1 - l2) <= 1e-8 * abs(l2)
    assert abs(n1 - n2) <= 1e-8 * n2
    gaps = [1.0 - torch.nn.functional.cosine_similarity(
        g1[n].flatten(), g2[n].flatten(), dim=0).item()
        for n in g2 if not n.endswith("k_proj.bias")]
    assert max(gaps) <= 1e-10


@pytest.mark.parametrize("quant", ["switchback", "int8"])
def test_quant_reaches_both_gradcache_phases(quant, monkeypatch):
    """With ``quant`` set, phase 1's no-grad forward and phase 3's forward
    and backward of every chunk take the int8 GEMMs: on the CUDA branch
    (launchers routed to the plain versions) each chunk launches phase 1's
    forward passes, then phase 3's forward and backward passes (dgrad but
    for the patch embedding; int8 wgrad in ``int8``), and the full-pool
    losses match JAX's ``gradcache_grads`` with the same ``quant`` (first
    step, same weights: within the exact path's 2e-5)."""
    from test_torch_quant import _counts, _cuda_branch

    seed = 31 + ["switchback", "int8"].index(quant)
    params = random_params(CFG, seed)
    batch = _batch(seed)
    jcfg = JaxTrainConfig(
        clip_model="tiny", batch_size=B, gradient_accumulation_steps=ACCUM,
        use_amp=False, loss_type="sparc", grad_cache=True, remat=False,
        use_pallas_attention=True, use_fused_sparc=True,
        inverse_temperature=0.07, quant=quant)
    _, jlosses = jax.jit(
        lambda p, b: jax_gradcache_grads(p, b, jcfg, JCFG, jnp.float32))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(x) for k, x in batch.items()})

    _cuda_branch(monkeypatch)
    model = tm.build_train_model(CFG, state_dict_from_jax(params, CFG),
                                 device="cpu")
    _build.reset_launch_counts()
    losses = gc.gradcache_grads(model, _torch(batch),
                                _cfg("sparc", quant=quant), CFG,
                                dtype=torch.float32)
    L = 6 * (CFG.vision.num_layers + CFG.text.num_layers) + 1
    int8 = quant == "int8"
    per_chunk = (2 * L + 2 * L + (L - 1), (L - 1) + 2 * L * int8,
                 L + L + (L - 1) + L * int8)
    assert _counts() == tuple(ACCUM * n for n in per_chunk)
    for k in jlosses:
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]),
                                   rtol=2e-5, err_msg=k)
