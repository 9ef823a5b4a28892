"""Analytic FLOP counts for model-FLOP rates.

The port's own copy of ``clip_finegrained_alignment_tpu/utils/flops.py``'s
forward and train-step counts (same conventions, same numbers; a train
step counts forward + 2× backward). Counted: every GEMM in
both towers (qkv/out/mlp projections, attention score and weighted-sum
products, patch embedding), the projections, and with ``sparc`` the SPARC
projection of both full hidden sequences and the SPARC loss products. Not
counted: elementwise work (LayerNorm, gelu, softmax) and embedding lookups.
``image_forward_flops`` and ``text_forward_flops`` split the
``sparc=False`` count between the towers, for per-tower serving rates.
"""

from __future__ import annotations

from ..config import CLIPConfig


def _tower_forward_flops(seq_len: int, hidden: int, intermediate: int,
                         num_layers: int) -> float:
    """Forward matmul FLOPs for one transformer tower, per sample.

    Per layer (MACs): q,k,v,out = 4·S·D²; MLP = 2·S·D·I;
    attention products = 2·S²·D. FLOPs = 2·MACs.
    """
    per_layer_macs = (4 * seq_len * hidden * hidden
                      + 2 * seq_len * hidden * intermediate
                      + 2 * seq_len * seq_len * hidden)
    return 2.0 * per_layer_macs * num_layers


def image_forward_flops(cfg: CLIPConfig) -> float:
    """``encode_image`` per image: the vision tower, the patch-embedding
    GEMM ([num_patches, p²·3] × [p²·3, D]) and the pooled projection."""
    v = cfg.vision
    return (_tower_forward_flops(v.seq_len, v.hidden_size,
                                 v.intermediate_size, v.num_layers)
            + 2.0 * v.num_patches * (v.patch_size ** 2 * 3) * v.hidden_size
            + 2.0 * v.hidden_size * cfg.projection_dim)


def text_forward_flops(cfg: CLIPConfig) -> float:
    """``encode_text`` per text: the text tower and the pooled projection."""
    t = cfg.text
    return (_tower_forward_flops(t.max_position_embeddings, t.hidden_size,
                                 t.intermediate_size, t.num_layers)
            + 2.0 * t.hidden_size * cfg.projection_dim)


def clip_forward_flops(cfg: CLIPConfig, *, sparc: bool = True) -> float:
    """Forward matmul FLOPs per image-text pair."""
    total = image_forward_flops(cfg) + text_forward_flops(cfg)
    if sparc:
        v, t = cfg.vision, cfg.text
        # SPARC projects the FULL hidden sequences ...
        total += 2.0 * (v.seq_len * v.hidden_size
                        + t.max_position_embeddings * t.hidden_size) \
            * cfg.projection_dim
        # ... and the loss runs similarity + pooling + 2 masked bmms.
        T, P, D = t.max_position_embeddings, v.seq_len, cfg.projection_dim
        total += 2.0 * (2 * T * P * D + 2 * T * T * D)
    return total


def sparc_train_step_flops(cfg: CLIPConfig, pairs_per_step: int) -> float:
    """Model FLOPs for one SPARC train step over ``pairs_per_step`` pairs
    (forward + 2× backward; recompute excluded by convention)."""
    return 3.0 * clip_forward_flops(cfg, sparc=True) * pairs_per_step


def count_train_step_flops(cfg: CLIPConfig, pairs_per_step: int,
                           n_cf: int = 9) -> float:
    """Model FLOPs for one counterfactual count-loss train step: the CLIP
    forward plus ``n_cf`` extra text-tower passes per pair (one batched
    [B·n_cf, T] forward), times 3."""
    return 3.0 * (clip_forward_flops(cfg, sparc=False)
                  + n_cf * text_forward_flops(cfg)) * pairs_per_step
