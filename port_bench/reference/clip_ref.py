"""The plain reference: CLIP's two towers, the SPARC loss and the AdamSPD
train step in plain PyTorch, fp32, with TF32 off.

It reads an HF-named state dict and the configuration file's HF keys, and
imports nothing of the port or of JAX. What it follows:

* CLIP (Radford et al. 2021; HF ``CLIPModel``): pre-LN transformer blocks,
  quick_gelu MLPs, the vision tower's class token and learned positions,
  pre- and post-LayerNorm, the text tower's causal mask and final
  LayerNorm, pooling at the first EOS token, bias-free projections.
  Images arrive as NHWC uint8, rescaled to [0, 1] and normalized by the
  CLIP mean and std; the patch embedding is a stride-p convolution,
  computed as a product of flattened patches.
* SPARC (Bica et al. 2024, arXiv:2401.09865) as the repository trains it:
  the global term over the mean of every vision token (class token
  included) and the mask-weighted mean of the text tokens, logits
  multiplied by the inverse temperature, cross-entropy summed then divided
  by B, both directions halved; the local term's similarity of normalized
  tokens and patches, min-max normalized over the patches, zeroed below the
  threshold, renormalized to sum to one, applied to the unnormalized
  patches, and a token-level contrastive loss over each caption's own
  tokens, mask-weighted.
* The step: the mean gradient of the microbatches, clipped to a global norm
  of ``max_grad_norm`` (g / ‖g‖ · max when ‖g‖ ≥ max), then Adam with
  Selective Projection Decay (Tian et al. 2024, arXiv:2411.01713): the Adam
  update with fp32 bias corrections, then per tensor, where
  −⟨g, p − p₀⟩ < 0, p ← p − wd · r · (p − p₀) with
  r = clip((‖p − p₀‖ − ‖p_prev − p₀‖) / ‖p − p₀‖, 0, 1) (r = 0 where the
  new value is the anchor). Parameters the loss does not reach take a zero
  gradient.

``gemm="fp8"`` rounds both operands of every product to float8 e4m3 (a
scale per row of the contracted dimension) before an fp32 product: the
control, one precision below bf16.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
NEG = -1e9
EPS = 1e-8
FP8_MAX = 448.0


def exact() -> None:
    """fp32 products as fp32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def matmul(a: torch.Tensor, b: torch.Tensor, gemm: str) -> torch.Tensor:
    """a [..., m, k] @ b [..., k, n]."""
    if gemm == "fp8":
        a, b = fp8(a, -1), fp8(b, -2)
    return a @ b


def linear(x, w, b=None, gemm="fp32"):
    y = matmul(x, w.t(), gemm)
    return y if b is None else y + b


def layer_norm(x, sd, name, eps):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"],
                        sd[name + ".bias"], eps)


def attention(x, sd, p, heads, bias, gemm):
    B, S, D = x.shape
    hd = D // heads
    q, k, v = (linear(x, sd[f"{p}.{n}_proj.weight"], sd[f"{p}.{n}_proj.bias"],
                      gemm).view(B, S, heads, hd).transpose(1, 2)
               for n in ("q", "k", "v"))
    scores = matmul(q * hd ** -0.5, k.transpose(-1, -2), gemm)
    if bias is not None:
        scores = scores + bias
    o = matmul(scores.softmax(-1), v, gemm)
    return linear(o.transpose(1, 2).reshape(B, S, D),
                  sd[f"{p}.out_proj.weight"], sd[f"{p}.out_proj.bias"], gemm)


def encoder(x, sd, prefix, layers, heads, eps, bias, gemm):
    for i in range(layers):
        p = f"{prefix}.encoder.layers.{i}"
        x = x + attention(layer_norm(x, sd, p + ".layer_norm1", eps), sd,
                          p + ".self_attn", heads, bias, gemm)
        h = linear(layer_norm(x, sd, p + ".layer_norm2", eps),
                   sd[p + ".mlp.fc1.weight"], sd[p + ".mlp.fc1.bias"], gemm)
        h = h * torch.sigmoid(1.702 * h)
        x = x + linear(h, sd[p + ".mlp.fc2.weight"], sd[p + ".mlp.fc2.bias"],
                       gemm)
    return x


def normalize_pixels(pixels: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC → normalized fp32."""
    x = pixels.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def vision(sd, cfg, pixels, gemm="fp32"):
    """(every token's hidden state before the post-LayerNorm [B, S, D], the
    post-LayerNormed class token [B, D]) of uint8 NHWC ``pixels``."""
    v = cfg["vision_config"]
    p, D, eps = v["patch_size"], v["hidden_size"], v["layer_norm_eps"]
    x = normalize_pixels(pixels)
    B, H, W, C = x.shape
    patches = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4)
    patches = patches.reshape(B, (H // p) * (W // p), C * p * p)
    w = sd["vision_model.embeddings.patch_embedding.weight"].reshape(D, -1)
    x = linear(patches, w, None, gemm)
    cls = sd["vision_model.embeddings.class_embedding"].expand(B, 1, D)
    x = torch.cat([cls, x], 1) \
        + sd["vision_model.embeddings.position_embedding.weight"]
    x = layer_norm(x, sd, "vision_model.pre_layrnorm", eps)
    x = encoder(x, sd, "vision_model", v["num_hidden_layers"],
                v["num_attention_heads"], eps, None, gemm)
    return x, layer_norm(x[:, 0], sd, "vision_model.post_layernorm", eps)


def text(sd, cfg, ids, gemm="fp32"):
    """(every token's hidden state after the final LayerNorm [B, T, D], the
    first EOS token's [B, D]) of ``ids`` [B, T]."""
    t = cfg["text_config"]
    eps = t["layer_norm_eps"]
    B, T = ids.shape
    x = sd["text_model.embeddings.token_embedding.weight"][ids.long()] \
        + sd["text_model.embeddings.position_embedding.weight"][:T]
    causal = torch.full((T, T), NEG, device=ids.device).triu(1)
    x = encoder(x, sd, "text_model", t["num_hidden_layers"],
                t["num_attention_heads"], eps, causal, gemm)
    x = layer_norm(x, sd, "text_model.final_layer_norm", eps)
    eos = (ids == t["eos_token_id"]).int().argmax(-1)
    return x, x[torch.arange(B, device=ids.device), eos]


def image_embeddings(sd, cfg, pixels, gemm="fp32") -> torch.Tensor:
    """L2-normalized projected image embeddings [B, P]."""
    e = linear(vision(sd, cfg, pixels, gemm)[1], sd["visual_projection.weight"],
               None, gemm)
    return e / e.norm(dim=-1, keepdim=True)


def _unit(x):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-24))


def _ce_sum_over_b(logits):
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels, reduction="sum") / logits.shape[0]


def sparc_loss(v_tok, l_tok, mask, tr) -> torch.Tensor:
    """The SPARC objective of projected vision tokens [B, P, E], projected
    text tokens [B, T, E] and the text mask [B, T]."""
    inv_t, thr = tr["inverse_temperature"], tr["similarity_threshold"]
    m = mask.float()
    v_g = _unit(v_tok.mean(1))
    l_g = _unit((l_tok * m[..., None]).sum(1)
                / m.sum(1, keepdim=True).clamp_min(EPS))
    glob = 0.5 * (_ce_sum_over_b(v_g @ l_g.t() * inv_t)
                  + _ce_sum_over_b(l_g @ v_g.t() * inv_t))
    sim = _unit(l_tok) @ _unit(v_tok).transpose(1, 2)            # [B, T, P]
    mk = m[..., None]
    lo = torch.where(mk > 0, sim * mk, 2.0).amin(-1, keepdim=True)
    hi = torch.where(mk > 0, sim * mk, -2.0).amax(-1, keepdim=True)
    w = (sim * mk - lo) / (hi - lo + EPS)
    w = torch.where(w < thr, torch.zeros_like(w), w) * mk
    w = w / w.sum(-1, keepdim=True).clamp_min(EPS)
    grouped = w @ v_tok                                           # [B, T, E]
    pair = m[:, :, None] * m[:, None, :]

    def local(a, b):
        logits = _unit(a) @ _unit(b).transpose(1, 2) * inv_t
        logits = torch.where(pair > 0, logits, torch.full_like(logits, NEG))
        per = torch.logsumexp(logits, -1) - torch.diagonal(logits, 0, 1, 2)
        return (per * m).sum() / (m.sum() + EPS)

    loc = 0.5 * (local(grouped, l_tok) + local(l_tok, grouped))
    return tr["global_loss_weight"] * glob + tr["local_loss_weight"] * loc


def sparc_microbatch_loss(sd, cfg, tr, pixels, ids) -> torch.Tensor:
    pad = cfg["text_config"]["pad_token_id"]
    v_hidden, _ = vision(sd, cfg, pixels)
    l_hidden, _ = text(sd, cfg, ids)
    v_tok = linear(v_hidden, sd["visual_projection.weight"])
    l_tok = linear(l_hidden, sd["text_projection.weight"])
    return sparc_loss(v_tok, l_tok, ids != pad, tr)


class AdamSPD:
    """The reference optimizer over a dict of fp32 leaves (see the module
    docstring), the anchors their values at construction."""

    def __init__(self, params: Dict[str, torch.Tensor], tr: dict):
        self.tr = tr
        self.anchor = {k: p.detach().clone() for k, p in params.items()}
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        b1, b2 = self.tr["betas"]
        lr, eps, wd = self.tr["lr"], self.tr["eps"], self.tr["weight_decay"]
        self.count += 1
        c = torch.tensor(float(self.count))
        bc1 = float(1.0 - torch.tensor(b1) ** c)
        bc2 = float(1.0 - torch.tensor(b2) ** c)
        for k, p in params.items():
            g, pre = grads[k], self.anchor[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            condition = -(g * (p - pre)).sum()
            prev = (p - pre).norm()
            p -= (lr / bc1) * self.m[k] / (self.v[k].sqrt() / math.sqrt(bc2)
                                           + eps)
            curr = (p - pre).norm()
            ratio = torch.where(curr == 0, torch.zeros_like(curr),
                                (curr - prev) / torch.where(
                                    curr == 0, torch.ones_like(curr), curr)
                                ).clamp(0.0, 1.0)
            if condition < 0:
                p -= wd * ratio * (p - pre)


def train_steps(sd0, cfg, tr, batches: List[dict]) -> dict:
    """The reference's first ``len(batches)`` SPARC + AdamSPD steps from the
    weights ``sd0``; each batch holds ``pixels`` [accum, B, S, S, 3] uint8
    and ``ids`` [accum, B, T]. Returns each step's loss, the first
    (clipped) gradient and each leaf's change after the last step."""
    exact()
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in sd0.items()}
    opt = AdamSPD(params, tr)
    losses, first_grad = [], None
    for batch in batches:
        accum = batch["ids"].shape[0]
        for p in params.values():
            p.grad = None
        total = 0.0
        for i in range(accum):
            loss = sparc_microbatch_loss(params, cfg, tr, batch["pixels"][i],
                                         batch["ids"][i])
            loss.backward()
            total += float(loss.detach()) / accum
        grads = {k: (p.grad / accum if p.grad is not None
                     else torch.zeros_like(p)) for k, p in params.items()}
        norm = torch.stack([g.pow(2).sum() for g in grads.values()]).sum() \
            .sqrt()
        if float(norm) >= tr["max_grad_norm"]:
            grads = {k: g / norm * tr["max_grad_norm"]
                     for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step({k: p.data for k, p in params.items()}, grads)
        losses.append(total)
    change = {k: p.detach() - sd0[k].float() for k, p in params.items()}
    return {"losses": losses, "grads": first_grad, "changes": change}
