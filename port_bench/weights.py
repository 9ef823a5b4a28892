"""Weights from the seed, on the device, in a few large calls.

:func:`shapes` lists a configuration's parameters under the HF
``CLIPModel`` names the port loads (``strict=True``) and the reference
reads. :func:`state_dict` draws them all as one normal fp32 buffer from a
``torch.Generator`` seeded with the seed and scales it in one pass: kernels
N(0, 1/fan_in), embeddings and biases N(0, 0.02²), LayerNorm scales
1 + N(0, 0.02²), the class embedding N(0, 1/D), ``logit_scale`` the
configuration's initial value. Every entry is a view of that buffer, so the
same seed on the same device gives the same weights, bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Spec = Tuple[str, Tuple[int, ...], float, float]   # name, shape, std, mean


def _layers(prefix: str, n: int, d: int, ff: int) -> List[Spec]:
    out: List[Spec] = []
    for i in range(n):
        p = f"{prefix}.encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(f"{p}self_attn.{proj}.weight", (d, d), d ** -0.5, 0.0),
                    (f"{p}self_attn.{proj}.bias", (d,), 0.02, 0.0)]
        for ln in ("layer_norm1", "layer_norm2"):
            out += [(f"{p}{ln}.weight", (d,), 0.02, 1.0),
                    (f"{p}{ln}.bias", (d,), 0.02, 0.0)]
        out += [(f"{p}mlp.fc1.weight", (ff, d), d ** -0.5, 0.0),
                (f"{p}mlp.fc1.bias", (ff,), 0.02, 0.0),
                (f"{p}mlp.fc2.weight", (d, ff), ff ** -0.5, 0.0),
                (f"{p}mlp.fc2.bias", (d,), 0.02, 0.0)]
    return out


def shapes(cfg: dict) -> List[Spec]:
    """Every parameter: (HF name, shape, std, mean)."""
    v, t = cfg["vision_config"], cfg["text_config"]
    dv, dt, P = v["hidden_size"], t["hidden_size"], cfg["projection_dim"]
    p = v["patch_size"]
    seq = (v["image_size"] // p) ** 2 + 1
    ln = (lambda name, d: [(f"{name}.weight", (d,), 0.02, 1.0),
                           (f"{name}.bias", (d,), 0.02, 0.0)])
    return [
        ("vision_model.embeddings.patch_embedding.weight", (dv, 3, p, p),
         (3 * p * p) ** -0.5, 0.0),
        ("vision_model.embeddings.class_embedding", (dv,), dv ** -0.5, 0.0),
        ("vision_model.embeddings.position_embedding.weight", (seq, dv),
         0.02, 0.0),
        *ln("vision_model.pre_layrnorm", dv),
        *_layers("vision_model", v["num_hidden_layers"], dv,
                 v["intermediate_size"]),
        *ln("vision_model.post_layernorm", dv),
        ("text_model.embeddings.token_embedding.weight",
         (t["vocab_size"], dt), 0.02, 0.0),
        ("text_model.embeddings.position_embedding.weight",
         (t["max_position_embeddings"], dt), 0.02, 0.0),
        *_layers("text_model", t["num_hidden_layers"], dt,
                 t["intermediate_size"]),
        *ln("text_model.final_layer_norm", dt),
        ("visual_projection.weight", (P, dv), dv ** -0.5, 0.0),
        ("text_projection.weight", (P, dt), dt ** -0.5, 0.0),
        ("logit_scale", (), 0.0, cfg["logit_scale_init_value"]),
    ]


def generator(seed: int, device):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def state_dict(cfg: dict, g, device) -> Dict[str, "object"]:
    """The seed's weights as an HF-named fp32 state dict of views of one
    buffer on ``device`` (drawn from generator ``g``)."""
    import torch
    specs = shapes(cfg)
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    flat.mul_(torch.repeat_interleave(
        torch.tensor([s[2] for s in specs], device=device), counts))
    flat.add_(torch.repeat_interleave(
        torch.tensor([s[3] for s in specs], device=device), counts))
    out, off = {}, 0
    for (name, shape, _, _), n in zip(specs, sizes):
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out
