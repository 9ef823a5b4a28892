"""Weights into and out of the port: the JAX package's param tree, random
weights from a seed, and reference ``.pt`` checkpoints in HF ``CLIPModel``
or OpenAI ``clip``-package naming (read by ``load_reference_checkpoint``,
written by ``save_reference_checkpoint``).

``state_dict_from_jax`` is the port's copy of ``clip_finegrained_alignment_
tpu/models/hf_export.py::hf_state_dict_from_params`` (same names, same
values, as torch tensors); it reads the tree through ``numpy.asarray``, so
it takes numpy arrays, or JAX arrays without importing JAX here.
``state_dict_from_openai`` and ``openai_state_dict`` are the OpenAI
halves of the JAX package's ``hf_import.py`` and ``hf_export.py``, mapped
straight between the two namings (the port's weights carry HF names).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import CLIPConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.require(x, np.float32, requirements="CW"))


def _per_layer(layers) -> list:
    """Stacked [L, ...] leaves (or an unstacked tuple) → per-layer trees."""
    if isinstance(layers, (list, tuple)):
        return list(layers)

    def index(tree, i):
        return {k: index(v, i) if isinstance(v, Mapping) else v[i]
                for k, v in tree.items()}

    first = layers
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    return [index(layers, i) for i in range(first.shape[0])]


def _linear_out(sd, prefix: str, p) -> None:
    sd[prefix + ".weight"] = _t(_np(p["kernel"]).T)  # torch: [out, in]
    if "bias" in p:
        sd[prefix + ".bias"] = _t(_np(p["bias"]))


def _layernorm_out(sd, prefix: str, p) -> None:
    sd[prefix + ".weight"] = _t(_np(p["scale"]))
    sd[prefix + ".bias"] = _t(_np(p["bias"]))


def _encoder_layers_out(sd, prefix: str, layers) -> None:
    for i, lp in enumerate(_per_layer(layers)):
        pre = f"{prefix}.layers.{i}"
        _layernorm_out(sd, f"{pre}.layer_norm1", lp["ln1"])
        _linear_out(sd, f"{pre}.self_attn.q_proj", lp["q"])
        _linear_out(sd, f"{pre}.self_attn.k_proj", lp["k"])
        _linear_out(sd, f"{pre}.self_attn.v_proj", lp["v"])
        _linear_out(sd, f"{pre}.self_attn.out_proj", lp["out"])
        _layernorm_out(sd, f"{pre}.layer_norm2", lp["ln2"])
        _linear_out(sd, f"{pre}.mlp.fc1", lp["fc1"])
        _linear_out(sd, f"{pre}.mlp.fc2", lp["fc2"])


def state_dict_from_jax(params: Mapping[str, Any],
                        cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's param tree → the port's state dict (HF names,
    fp32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    v, t = params["vision"], params["text"]
    ps = cfg.vision.patch_size
    # matmul kernel [ps*ps*3, D] → conv weight [D, 3, ps, ps]; the
    # flattening is (row in patch, column in patch, channel).
    kernel = _np(v["patch_embedding"]["kernel"])
    sd["vision_model.embeddings.patch_embedding.weight"] = _t(
        kernel.reshape(ps, ps, 3, -1).transpose(3, 2, 0, 1))
    sd["vision_model.embeddings.class_embedding"] = _t(
        _np(v["class_embedding"]))
    sd["vision_model.embeddings.position_embedding.weight"] = _t(
        _np(v["position_embedding"]))
    _layernorm_out(sd, "vision_model.pre_layrnorm", v["pre_layernorm"])
    _layernorm_out(sd, "vision_model.post_layernorm", v["post_layernorm"])
    _encoder_layers_out(sd, "vision_model.encoder", v["layers"])

    sd["text_model.embeddings.token_embedding.weight"] = _t(
        _np(t["token_embedding"]))
    sd["text_model.embeddings.position_embedding.weight"] = _t(
        _np(t["position_embedding"]))
    _layernorm_out(sd, "text_model.final_layer_norm", t["final_layernorm"])
    _encoder_layers_out(sd, "text_model.encoder", t["layers"])

    _linear_out(sd, "visual_projection", params["visual_projection"])
    _linear_out(sd, "text_projection", params["text_projection"])
    sd["logit_scale"] = _t(_np(params["logit_scale"]).reshape(()))
    return sd


def random_params(cfg: CLIPConfig, seed: int = 0) -> Dict[str, Any]:
    """Random weights in the JAX package's tree layout (numpy, layers
    stacked [L, ...]), drawn with numpy from ``seed``.

    The scales follow ``clip_finegrained_alignment_tpu/models/clip.py::
    init_clip_params`` (kernels N(0, 1/d_in), embeddings N(0, 0.02²),
    class embedding N(0, 1/D)); biases are N(0, 0.02²) and LayerNorm
    scales 1 + N(0, 0.02²) instead of exact zeros and ones, so that every
    parameter reaches the output."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def lin(d_in, d_out, bias=True):
        p = {"kernel": normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["bias"] = normal((d_out,), 0.02)
        return p

    def ln(d):
        return {"scale": 1.0 + normal((d,), 0.02), "bias": normal((d,), 0.02)}

    def layers(n, d, d_ff):
        per = [{"ln1": ln(d), "q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                "out": lin(d, d), "ln2": ln(d), "fc1": lin(d, d_ff),
                "fc2": lin(d_ff, d)} for _ in range(n)]

        def stack(*trees):
            if isinstance(trees[0], Mapping):
                return {k: stack(*(t[k] for t in trees)) for k in trees[0]}
            return np.stack(trees)
        return stack(*per)

    v, t = cfg.vision, cfg.text
    patch_dim = v.patch_size * v.patch_size * 3
    return {
        "vision": {
            "patch_embedding": {"kernel": normal((patch_dim, v.hidden_size),
                                                 patch_dim ** -0.5)},
            "class_embedding": normal((v.hidden_size,), v.hidden_size ** -0.5),
            "position_embedding": normal((v.seq_len, v.hidden_size), 0.02),
            "pre_layernorm": ln(v.hidden_size),
            "post_layernorm": ln(v.hidden_size),
            "layers": layers(v.num_layers, v.hidden_size,
                             v.intermediate_size),
        },
        "text": {
            "token_embedding": normal((t.vocab_size, t.hidden_size), 0.02),
            "position_embedding": normal((t.max_position_embeddings,
                                          t.hidden_size), 0.02),
            "final_layernorm": ln(t.hidden_size),
            "layers": layers(t.num_layers, t.hidden_size,
                             t.intermediate_size),
        },
        "visual_projection": lin(v.hidden_size, cfg.projection_dim,
                                 bias=False),
        "text_projection": lin(t.hidden_size, cfg.projection_dim,
                               bias=False),
        "logit_scale": np.asarray(cfg.logit_scale_init, np.float32),
    }


# ---------------------------------------------------------------------------
# OpenAI clip-package naming (the reference count trainer's checkpoints)
# ---------------------------------------------------------------------------

def _strip_wrapper(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop a ``module.`` (DDP) or ``model.`` prefix from every key."""
    return {re.sub(r"^(module\.|model\.)", "", k): v for k, v in sd.items()}


def is_openai_state_dict(sd: Mapping[str, Any]) -> bool:
    """OpenAI ``clip``-package names (what the reference's count trainer
    saves), as opposed to HF ``CLIPModel`` names."""
    sd = _strip_wrapper(sd)
    return "visual.conv1.weight" in sd or "visual.class_embedding" in sd


def _towers(cfg: CLIPConfig):
    """(OpenAI block prefix, HF layer prefix, layers, width) per tower."""
    return (("visual.transformer.resblocks", "vision_model.encoder.layers",
             cfg.vision.num_layers, cfg.vision.hidden_size),
            ("transformer.resblocks", "text_model.encoder.layers",
             cfg.text.num_layers, cfg.text.hidden_size))


# (OpenAI, HF) names of the tensors that map one to one, weight and bias.
_OPENAI_LAYER_PAIRS = (("ln_1", "layer_norm1"), ("attn.out_proj",
                       "self_attn.out_proj"), ("ln_2", "layer_norm2"),
                       ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2"))
_OPENAI_TOP_PAIRS = (("visual.ln_pre", "vision_model.pre_layrnorm"),
                     ("visual.ln_post", "vision_model.post_layernorm"),
                     ("ln_final", "text_model.final_layer_norm"))


def state_dict_from_openai(sd: Mapping[str, Any],
                           cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """An OpenAI ``clip``-package ``model.state_dict()`` → the port's HF
    names (fp32 CPU tensors; OpenAI ships fp16). The port of
    ``hf_import.params_from_openai_state_dict``: the fused
    ``attn.in_proj_weight`` [3D, D] splits into q, k, v rows (torch
    ``MultiheadAttention``'s packing), and the projections, stored as
    ``x @ proj`` matrices, are transposed into linear weights."""
    sd = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
          for k, v in _strip_wrapper(sd).items()}
    out = {
        "vision_model.embeddings.patch_embedding.weight":
            sd["visual.conv1.weight"],
        "vision_model.embeddings.class_embedding":
            sd["visual.class_embedding"].reshape(-1),
        "vision_model.embeddings.position_embedding.weight":
            sd["visual.positional_embedding"],
        "visual_projection.weight": sd["visual.proj"].t(),
        "text_model.embeddings.token_embedding.weight":
            sd["token_embedding.weight"],
        "text_model.embeddings.position_embedding.weight":
            sd["positional_embedding"],
        "text_projection.weight": sd["text_projection"].t(),
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    for src, dst in _OPENAI_TOP_PAIRS:
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]
    for src, dst, layers, d in _towers(cfg):
        for i in range(layers):
            s, t = f"{src}.{i}", f"{dst}.{i}"
            for leaf, packed in (("weight", "in_proj_weight"),
                                 ("bias", "in_proj_bias")):
                rows = sd[f"{s}.attn.{packed}"]
                for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
                    out[f"{t}.self_attn.{proj}.{leaf}"] = \
                        rows[j * d:(j + 1) * d]
            for a, b in _OPENAI_LAYER_PAIRS:
                for leaf in ("weight", "bias"):
                    out[f"{t}.{b}.{leaf}"] = sd[f"{s}.{a}.{leaf}"]
    return {k: v.contiguous().clone() for k, v in out.items()}


def openai_state_dict(model, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """The port's weights (a ``CLIPModel`` or its HF-named state dict) →
    OpenAI ``clip``-package names, fp32 CPU tensors: the port of
    ``hf_export.openai_state_dict_from_params``. q, k, v fuse into
    ``attn.in_proj_*``; the projections become ``x @ proj`` matrices. The
    buffers the clip package makes itself (``attn_mask``) are left out."""
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in sd.items()}
    out = {
        "visual.conv1.weight":
            sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding":
            sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding":
            sd["vision_model.embeddings.position_embedding.weight"],
        "visual.proj": sd["visual_projection.weight"].t(),
        "token_embedding.weight":
            sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding":
            sd["text_model.embeddings.position_embedding.weight"],
        "text_projection": sd["text_projection.weight"].t(),
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    for dst, src in _OPENAI_TOP_PAIRS:
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]
    for dst, src, layers, _ in _towers(cfg):
        for i in range(layers):
            s, t = f"{src}.{i}", f"{dst}.{i}"
            for leaf, packed in (("weight", "in_proj_weight"),
                                 ("bias", "in_proj_bias")):
                out[f"{t}.attn.{packed}"] = torch.cat(
                    [sd[f"{s}.self_attn.{p}.{leaf}"]
                     for p in ("q_proj", "k_proj", "v_proj")])
            for a, b in _OPENAI_LAYER_PAIRS:
                for leaf in ("weight", "bias"):
                    out[f"{t}.{a}.{leaf}"] = sd[f"{s}.{b}.{leaf}"]
    return {k: v.contiguous().clone() for k, v in out.items()}


def load_reference_checkpoint(path: str, cfg: Optional[CLIPConfig] = None
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, Any]]:
    """A reference torch checkpoint (``model_state_dict`` + metadata, or a
    bare state dict) in HF ``CLIPModel`` or OpenAI ``clip``-package naming
    → (HF-named state dict, metadata). ``cfg`` is needed for OpenAI naming
    only (the layer counts and widths that split ``in_proj``). HF
    ``position_ids`` buffers are dropped. Loaded with ``weights_only``:
    tensors and plain containers only (an ``optimizer_state_dict`` among
    the metadata included)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    if is_openai_state_dict(sd):
        if cfg is None:
            raise ValueError(f"{path}: OpenAI clip-package naming; pass the "
                             "model config to split its fused projections")
        sd = state_dict_from_openai(sd, cfg)
    else:
        sd = {k: v.float() for k, v in sd.items()
              if not k.endswith("position_ids")}
    meta = {k: v for k, v in ckpt.items() if k != "model_state_dict"} \
        if "model_state_dict" in ckpt else {}
    return sd, meta


def save_reference_checkpoint(path: str, model, cfg: CLIPConfig, *,
                              global_step: int = 0,
                              best_loss: float = float("inf"),
                              config: Optional[dict] = None,
                              optimizer_state_dict: Optional[dict] = None,
                              fmt: str = "hf") -> None:
    """Write the reference's training-checkpoint format
    (``model_state_dict``, ``global_step``, ``best_loss``, ``config``),
    the port of ``clip_finegrained_alignment_tpu/models/hf_export.py::
    save_reference_checkpoint``. ``model``: a ``models/clip.py::CLIPModel``
    or its state dict. ``fmt="hf"`` writes HF ``CLIPModel`` names (HF's
    ``CLIPModel.load_state_dict`` and the JAX package's
    ``hf_import.load_reference_checkpoint`` read them), ``fmt="openai"``
    the OpenAI ``clip``-package names (the reference count trainer's
    resume format). ``optimizer_state_dict`` (a reference optimizer state
    from ``optim/interop.py``) makes it a complete training checkpoint.
    The weights are fp32 CPU tensors. The file is written to a temporary
    name and renamed."""
    if fmt not in ("hf", "openai"):
        raise ValueError(f"fmt must be 'hf' or 'openai', got {fmt!r}")
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    if "vision_model.embeddings.patch_embedding.weight" not in sd:
        raise ValueError("not an HF-named CLIP state dict")
    shape = tuple(sd["vision_model.embeddings.position_embedding.weight"]
                  .shape)
    if shape != (cfg.vision.seq_len, cfg.vision.hidden_size):
        raise ValueError(f"state dict does not fit {cfg}: vision position "
                         f"embedding {shape}")
    sd = openai_state_dict(sd, cfg) if fmt == "openai" else \
        {k: v.detach().to("cpu", torch.float32).clone()
         for k, v in sd.items()}
    out = {
        "model_state_dict": sd,
        "global_step": int(global_step),
        "best_loss": float(best_loss),
        "config": dict(config or {}),
    }
    if optimizer_state_dict is not None:
        out["optimizer_state_dict"] = optimizer_state_dict
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(out, tmp)
    os.replace(tmp, path)
