"""The port's CLIP model (``clip_finegrained_alignment_tpu_torch/models``)
against the JAX package's, on the same weights.

Weights come from the JAX side (``init_clip_params``, then numpy noise on
biases and LayerNorms so that every parameter reaches the output) and go
through ``state_dict_from_jax``; inputs are numpy from a seed.

Tolerances: fp32 ``rtol=1e-4, atol=1e-5`` (both sides compute in fp32 with
full-precision matmuls; they differ only in summation order). bf16: unit
embeddings ``atol=1e-2``, logits ``atol=0.15`` (logit_scale ≈ 14.3 times
the embedding error) and hidden states 4 % of the tensor's largest
magnitude: bf16 keeps 8 significant bits (a step of 2^-8 ≈ 0.4 % at the
top of each binade), and the two frameworks round matmul, LayerNorm and
gelu outputs at slightly different points, which drifts a few steps over
the layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.config import (
    CLIPConfig as JaxCLIPConfig, TextConfig as JaxTextConfig,
    VisionConfig as JaxVisionConfig)
from clip_finegrained_alignment_tpu.models import clip as jm
from clip_finegrained_alignment_tpu.models.hf_export import \
    hf_state_dict_from_params
from clip_finegrained_alignment_tpu_torch.config import (
    CLIPConfig, TextConfig, VisionConfig)
from clip_finegrained_alignment_tpu_torch.models import clip as tm
from clip_finegrained_alignment_tpu_torch.models.convert import (
    load_reference_checkpoint, random_params, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.ops import _build


def _perturb(tree, rng):
    """numpy copy of a param tree with biases and LayerNorms moved off
    their zero / one init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        else:
            a = np.asarray(v, np.float32)
            if k in ("bias", "scale"):
                a = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
            out[k] = a
    return out


def _params(jcfg, seed):
    return _perturb(jm.init_clip_params(jax.random.key(seed), jcfg),
                    np.random.default_rng(seed))


def _inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    S = cfg.vision.image_size
    pix = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    T, t = cfg.text.max_position_embeddings, cfg.text
    ids = rng.integers(1, min(t.vocab_size, t.bos_token_id) - 1,
                       size=(B, T)).astype(np.int32)
    ids[:, 0] = t.bos_token_id
    for b in range(B):                       # EOS at varying positions,
        ids[b, 3 + 2 * b] = t.eos_token_id   # a second EOS after it
        ids[b, T - 1] = t.eos_token_id
    return pix, ids


def _jax_out(params, pix, ids, jcfg, dtype=jnp.float32, mask=None):
    jp = jax.tree.map(jnp.asarray, params)
    return jm.clip_forward(jp, jnp.asarray(pix), jnp.asarray(ids), jcfg,
                           attention_mask=None if mask is None
                           else jnp.asarray(mask), dtype=dtype)


def _torch_out(sd, cfg, pix, ids, dtype=torch.float32, mask=None):
    model = tm.build_model(cfg, sd, device="cpu", dtype=dtype)
    with torch.inference_mode():
        return tm.clip_forward(model, torch.from_numpy(pix),
                               torch.from_numpy(ids),
                               attention_mask=None if mask is None
                               else torch.from_numpy(mask), dtype=dtype)


def _close(jax_x, torch_x, **tol):
    np.testing.assert_allclose(torch_x.detach().float().numpy(),
                               np.asarray(jax_x, np.float32), **tol)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = JaxCLIPConfig.tiny_test(), CLIPConfig.tiny_test()
    params = _params(jcfg, 0)
    return jcfg, cfg, params, state_dict_from_jax(params, cfg)


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_state_dict_equals_hf_export(tiny, layout):
    jcfg, cfg, params, _ = tiny
    if layout == "unstacked":
        params = jm.unstack_layers(params)
    ours = state_dict_from_jax(params, cfg)
    ref = hf_state_dict_from_params(params, jcfg)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_model_parameter_names_are_hf_names(tiny):
    _, cfg, _, sd = tiny
    model = tm.build_model(cfg, sd, device="cpu")
    assert sorted(model.state_dict()) == sorted(sd)
    assert "vision_model.pre_layrnorm.weight" in sd


def test_reference_checkpoint_loads_strict(tiny, tmp_path):
    """An HF-named reference .pt (with HF's position_ids buffers) loads
    through ``load_reference_checkpoint`` into a strict model."""
    _, cfg, _, sd = tiny
    ckpt = dict(sd)
    ckpt["vision_model.embeddings.position_ids"] = torch.arange(
        cfg.vision.seq_len)[None]
    ckpt["text_model.embeddings.position_ids"] = torch.arange(
        cfg.text.max_position_embeddings)[None]
    path = tmp_path / "ref.pt"
    torch.save({"model_state_dict": ckpt, "global_step": 7,
                "best_loss": 1.5, "config": {"lr": 1e-5}}, path)
    loaded, meta = load_reference_checkpoint(str(path))
    assert meta["global_step"] == 7
    model = tm.build_model(cfg, loaded, device="cpu")
    for k, v in sd.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_clip_forward_matches_jax_fp32(tiny):
    jcfg, cfg, params, sd = tiny
    pix, ids = _inputs(cfg, 3, seed=1)
    ref = _jax_out(params, pix, ids, jcfg)
    _build.reset_launch_counts()
    out = _torch_out(sd, cfg, pix, ids)
    # The CPU runs the plain version.
    assert _build.launch_counts()["attention_fwd"] == 0
    for f in ref._fields:
        _close(getattr(ref, f), getattr(out, f), rtol=1e-4, atol=1e-5)


def test_encode_image_and_text_match_jax_fp32(tiny):
    jcfg, cfg, params, sd = tiny
    pix, ids = _inputs(cfg, 2, seed=2)
    jp = jax.tree.map(jnp.asarray, params)
    model = tm.build_model(cfg, sd, device="cpu")
    with torch.inference_mode():
        img = tm.encode_image(model, torch.from_numpy(pix))
        txt = tm.encode_text(model, torch.from_numpy(ids))
    _close(jm.encode_image(jp, jnp.asarray(pix), jcfg), img,
           rtol=1e-4, atol=1e-5)
    _close(jm.encode_text(jp, jnp.asarray(ids), jcfg), txt,
           rtol=1e-4, atol=1e-5)


def test_text_attention_mask_matches_jax_fp32(tiny):
    jcfg, cfg, params, sd = tiny
    pix, ids = _inputs(cfg, 2, seed=3)
    mask = np.ones(ids.shape, np.int32)
    mask[0, 10:] = 0
    ref = _jax_out(params, pix, ids, jcfg, mask=mask)
    out = _torch_out(sd, cfg, pix, ids, mask=mask)
    _close(ref.text_embeds, out.text_embeds, rtol=1e-4, atol=1e-5)
    _close(ref.text_last_hidden_state, out.text_last_hidden_state,
           rtol=1e-4, atol=1e-5)


def test_full_width_two_layer_model_matches_jax_fp32():
    """ViT-B/16's widths (768 vision, 12 heads, S=197; 512 text, 8 heads,
    T=77) cut to 2 layers per tower and a 4096-token vocabulary."""
    jcfg = JaxCLIPConfig(
        vision=JaxVisionConfig(patch_size=16, num_layers=2),
        text=JaxTextConfig(num_layers=2, vocab_size=4096,
                           bos_token_id=4094, eos_token_id=4095))
    cfg = CLIPConfig(
        vision=VisionConfig(patch_size=16, num_layers=2),
        text=TextConfig(num_layers=2, vocab_size=4096,
                        bos_token_id=4094, eos_token_id=4095))
    params = _params(jcfg, 5)
    pix, ids = _inputs(cfg, 2, seed=5)
    ref = _jax_out(params, pix, ids, jcfg)
    out = _torch_out(state_dict_from_jax(params, cfg), cfg, pix, ids)
    for f in ("image_embeds", "text_embeds", "logits_per_image",
              "vision_pooled", "text_pooled"):
        _close(getattr(ref, f), getattr(out, f), rtol=1e-4, atol=1e-4)


def test_clip_forward_matches_jax_bf16(tiny, monkeypatch):
    """bf16 compute with fp32 attention probabilities on the JAX side (the
    Pallas kernel's and the port's numerics)."""
    monkeypatch.setenv("CFA_ATTENTION_PROBS_FP32", "1")
    jcfg, cfg, params, sd = tiny
    pix, ids = _inputs(cfg, 3, seed=4)
    ref = _jax_out(params, pix, ids, jcfg, dtype=jnp.bfloat16)
    out = _torch_out(sd, cfg, pix, ids, dtype=torch.bfloat16)
    assert out.vision_last_hidden_state.dtype == torch.bfloat16
    _close(ref.image_embeds, out.image_embeds, rtol=0, atol=1e-2)
    _close(ref.text_embeds, out.text_embeds, rtol=0, atol=1e-2)
    _close(ref.logits_per_image, out.logits_per_image, rtol=0, atol=0.15)
    for f in ("vision_last_hidden_state", "text_last_hidden_state",
              "vision_pooled", "text_pooled"):
        r = np.asarray(getattr(ref, f), np.float32)
        _close(r, getattr(out, f), rtol=0, atol=0.04 * np.abs(r).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_primitives_match_jax(dtype):
    """layer_norm (fp32 statistics), quick_gelu (1.702 rounded to the
    dtype) and linear (cast, matmul, then bias in the product's dtype).
    fp32: 1e-6; bf16: two bf16 steps (2^-6 relative), because XLA rounds
    the sigmoid's intermediate results to bf16 where PyTorch rounds once.
    """
    rng = np.random.default_rng(9)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.standard_normal((4, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32) * 0.2
    b = rng.standard_normal(16).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(32)).astype(np.float32)
    jx = jnp.asarray(x).astype(jd)
    tx = torch.from_numpy(x).to(td)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2 ** -6, atol=2 ** -6)

    ln = torch.nn.LayerNorm(32, eps=1e-5)
    ln.weight.data, ln.bias.data = torch.from_numpy(g), torch.from_numpy(beta)
    _close(jm.layer_norm({"scale": jnp.asarray(g), "bias": jnp.asarray(beta)},
                         jx, 1e-5), tm.layer_norm(ln, tx), **tol)
    _close(jm.quick_gelu(jx), tm.quick_gelu(tx), **tol)
    _close(jm.linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jx, jd),
           tm.linear(tx, torch.from_numpy(w.T.copy()), torch.from_numpy(b),
                     td), **tol)


def test_patchify_matches_jax():
    rng = np.random.default_rng(11)
    pix = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tm.patchify(torch.from_numpy(pix), 8).numpy(),
        np.asarray(jm.patchify(jnp.asarray(pix), 8)))


def test_random_params_have_the_jax_tree_layout():
    cfg, jcfg = CLIPConfig.tiny_test(), JaxCLIPConfig.tiny_test()
    ours = random_params(cfg, seed=0)
    ref = jm.init_clip_params(jax.random.key(0), jcfg)
    ours_shapes = jax.tree.map(np.shape, ours)
    ref_shapes = jax.tree.map(np.shape, ref)
    assert ours_shapes == ref_shapes
    again = random_params(cfg, seed=0)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(ours), jax.tree.leaves(again)))


def test_build_model_refuses_cuda_without_a_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    _, cfg, _, sd = tiny
    with pytest.raises(RuntimeError, match="cuda"):
        tm.build_model(cfg, sd, device="cuda")
