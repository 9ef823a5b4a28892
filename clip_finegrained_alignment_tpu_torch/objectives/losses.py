"""The four training objectives in PyTorch, the port of
``clip_finegrained_alignment_tpu/objectives/losses.py`` (same loss dicts,
same numerics). Every reduction is fp32 whatever the compute dtype.

Kept from the JAX package, which keeps them from the reference:

* SPARC multiplies ``inverse_temperature`` into its logits (the trainer
  sets 0.07, so logits shrink);
* SPARC's global term is CE summed, then divided by B;
* the global term's vision embedding is the mean over ALL vision tokens,
  the class token included;
* finite ``_NEG`` fills and mask multiplies instead of ``-inf``, so fully
  masked rows give 0, not NaN;
* ``count_loss``'s denominator sums the counterfactuals only (the
  positive is left out).

The SPARC local term goes through ``ops/sparc_kernel.py::
fused_sparc_pooling``: its CUDA kernels on the card, its plain version on
the CPU. The JAX package's ``use_fused=False`` branch computes the same
function (``tests/test_ops.py::test_sparc_loss_fused_flag_equivalence``).

Global negatives (``sparc_loss(..., mesh=...)``; the other objectives
gather their inputs in ``train/engine.py::compute_loss``): the pooled
embeddings of SPARC's global term are gathered over the data ranks (a
gather whose backward sums over them, ``parallel/collectives.py``), so
every rank computes the global batch's term. The local token↔patch term
is per sample and stays on the rank's rows (the SPARC kernels run at
B/W), but its token-weighted mean divides by the global batch's token
count, and each rank's term is scaled by W: the mean of the ranks' terms
is then the global batch's term exactly, whatever the captions' lengths
(a mean of the ranks' own means would weigh a rank's tokens by its
count).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.sparc_kernel import (EPS as _EPS, fused_sparc_pooling,
                                l2_normalize, sparc_alignment_weights)

_NEG = -1e9  # finite stand-in for -inf fills

__all__ = ["l2_normalize", "softmax_cross_entropy", "clip_loss",
           "grouped_count_loss", "clip_count_loss",
           "pairwise_contrastive_loss", "masked_pairwise_contrastive_loss",
           "sparc_alignment_weights", "sparc_loss", "count_loss"]


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE with integer labels, in fp32. [..., C] → [...]."""
    logits = logits.float()
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              temperature: float = 0.07) -> Dict[str, torch.Tensor]:
    """Bidirectional CLIP contrastive loss."""
    img = l2_normalize(image_features.float())
    txt = l2_normalize(text_features.float())
    logits = (img @ txt.t()) / temperature
    labels = _arange(logits.shape[0], logits)
    total = (softmax_cross_entropy(logits, labels).mean()
             + softmax_cross_entropy(logits.t(), labels).mean()) / 2.0
    return {"clip_loss": total, "total_loss": total}


def grouped_count_loss(ei: torch.Tensor, ek_groups: torch.Tensor,
                       temperature: float = 0.07) -> torch.Tensor:
    """Per-image grouped count term: ei [B, D], ek_groups [B, G, D] with
    the positive caption in slot 0; −log softmax of slot 0, mean over B."""
    ei = l2_normalize(ei.float())
    ek = l2_normalize(ek_groups.float())
    sims = torch.einsum("bd,bgd->bg", ei, ek) / temperature
    return (torch.logsumexp(sims, dim=-1) - sims[:, 0]).mean()


def clip_count_loss(image_features: torch.Tensor,
                    text_features: torch.Tensor,
                    count_groups: Optional[torch.Tensor] = None,
                    temperature: float = 0.07,
                    count_alpha: float = 0.5) -> Dict[str, torch.Tensor]:
    """CLIP loss over a template-expanded batch (text_features [B·T, D],
    diagonal-positive after repeating each image T times) plus the grouped
    count term on ``count_groups`` [B, G, D] (None → 0)."""
    B = image_features.shape[0]
    expanded = text_features.shape[0]
    img = l2_normalize(image_features.float())
    txt = l2_normalize(text_features.float())
    img_expanded = torch.repeat_interleave(img, expanded // B, dim=0)
    logits = (img_expanded @ txt.t()) / temperature
    labels = _arange(expanded, logits)
    closs = (softmax_cross_entropy(logits, labels).mean()
             + softmax_cross_entropy(logits.t(), labels).mean()) / 2.0
    if count_groups is not None:
        count = grouped_count_loss(img_expanded, count_groups,
                                   temperature) * count_alpha
    else:
        count = torch.zeros((), dtype=torch.float32, device=logits.device)
    return {"clip_loss": closs, "count_loss": count,
            "total_loss": closs + count}


def pairwise_contrastive_loss(a: torch.Tensor, b: torch.Tensor,
                              inverse_temperature: float) -> torch.Tensor:
    """Normalize, logits = a·bᵀ·inv_τ, CE summed over the batch / B."""
    a = l2_normalize(a.float())
    b = l2_normalize(b.float())
    B = a.shape[0]
    logits = (a @ b.t()) * inverse_temperature
    return softmax_cross_entropy(logits, _arange(B, logits)).sum() / B


def masked_pairwise_contrastive_loss(a: torch.Tensor, b: torch.Tensor,
                                     mask: torch.Tensor,
                                     inverse_temperature: float,
                                     token_count: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """Token-level contrastive term: a, b [B, T, D], mask [B, T]; masked
    pairs are filled with the finite ``_NEG`` and masked tokens weigh 0.
    ``token_count``: the mean's denominator (default ``mask.sum()``)."""
    a = l2_normalize(a.float())
    b = l2_normalize(b.float())
    B, T = a.shape[0], a.shape[1]
    mask = mask.float()
    mask2d = mask[:, :, None] * mask[:, None, :]
    logits = torch.einsum("btd,bsd->bts", a, b) * inverse_temperature
    logits = torch.where(mask2d > 0, logits, torch.full_like(logits, _NEG))
    labels = _arange(T, logits)[None, :].expand(B, T)
    per_token = softmax_cross_entropy(logits, labels)
    count = mask.sum() if token_count is None else token_count
    return (per_token * mask).sum() / (count + _EPS)


def sparc_loss(v_patch_embed: torch.Tensor, l_token_embed: torch.Tensor,
               language_mask: torch.Tensor, *,
               similarity_threshold: float = 0.5,
               global_loss_weight: float = 1.0,
               local_loss_weight: float = 1.0,
               inverse_temperature: float = 1.0,
               mesh=None) -> Dict[str, torch.Tensor]:
    """SPARC patch↔token alignment loss. v_patch_embed [B, P, D] projected
    vision hidden states (all tokens), l_token_embed [B, T, D] projected
    text hidden states, language_mask [B, T]. ``mesh``: global negatives
    over its data ranks (module docstring)."""
    v_patch_embed = v_patch_embed.float()
    l_token_embed = l_token_embed.float()
    mask = language_mask.float()

    # ---------- global ----------
    v_embed = l2_normalize(v_patch_embed.mean(dim=1))
    masked_l = l_token_embed * mask[:, :, None]
    token_counts = torch.clamp_min(mask.sum(-1, keepdim=True), _EPS)
    l_embed = l2_normalize(masked_l.sum(dim=1) / token_counts)
    if mesh is not None:
        v_embed, l_embed = mesh.gather(v_embed), mesh.gather(l_embed)
    loss_vl = pairwise_contrastive_loss(v_embed, l_embed, inverse_temperature)
    loss_lv = pairwise_contrastive_loss(l_embed, v_embed, inverse_temperature)
    global_loss = 0.5 * (loss_vl + loss_lv)

    # ---------- local ----------
    l_grouped = fused_sparc_pooling(v_patch_embed, l_token_embed, mask,
                                    similarity_threshold)
    tokens, scale = None, 1
    if mesh is not None:
        tokens, scale = mesh.total(mask.sum()), mesh.data
    loss_vl_local = scale * masked_pairwise_contrastive_loss(
        l_grouped, l_token_embed, mask, inverse_temperature, tokens)
    loss_lv_local = scale * masked_pairwise_contrastive_loss(
        l_token_embed, l_grouped, mask, inverse_temperature, tokens)
    local_loss = 0.5 * (loss_vl_local + loss_lv_local)

    total = global_loss_weight * global_loss + local_loss_weight * local_loss
    return {
        "global_loss": global_loss,
        "local_loss": local_loss,
        "total_loss": total,
        "loss_vl": loss_vl,
        "loss_lv": loss_lv,
        "loss_vl_local": loss_vl_local,
        "loss_lv_local": loss_lv_local,
    }


def count_loss(img_logits: torch.Tensor, text_logits: torch.Tensor,
               ei: torch.Tensor, ek: torch.Tensor, ek_cf: torch.Tensor,
               temperature: float = 0.07,
               alpha: float = 1.0) -> Dict[str, torch.Tensor]:
    """CLIP CE on precomputed logits [B, B] plus the counterfactual term:
    ei, ek [B, D] image and positive caption embeddings, ek_cf [B, N, D]
    counterfactual captions; −log(e^pos / Σ e^cf), positive left out of the
    denominator."""
    B = img_logits.shape[0]
    labels = _arange(B, img_logits)
    closs = (softmax_cross_entropy(img_logits, labels).mean()
             + softmax_cross_entropy(text_logits, labels).mean()) / 2.0
    ei = l2_normalize(ei.float())
    ek = l2_normalize(ek.float())
    ek_cf = l2_normalize(ek_cf.float())
    correct = (ei * ek).sum(-1) / temperature
    cf_scores = torch.einsum("bd,bnd->bn", ei, ek_cf) / temperature
    closs_count = (torch.logsumexp(cf_scores, dim=-1) - correct).mean()
    return {"clip_loss": closs, "count_loss": closs_count,
            "total_loss": closs + alpha * closs_count}
