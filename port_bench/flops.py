"""Model FLOPs and the card's peaks: the benchmark's frozen copies.

The counts are those of the port's ``utils/flops.py`` (same conventions,
same numbers; ``tests/test_port_bench_counts.py`` holds them equal), read
from a configuration file's HF keys: every GEMM of both towers (q, k, v,
out, MLP, the attention score and weighted-sum products, the patch
embedding), the projections, and under SPARC the projection of both full
hidden sequences and the SPARC loss products. A train step counts forward
+ 2 × backward. Elementwise work and embedding lookups are not counted.

Peaks: one H100 SXM, NVIDIA's data sheet, dense, at 700 W. ``fp32`` is the
rate of fp32-accurate products on the tensor cores as three TF32 products
(the port's fp32 kernels compute so), a third of TF32's.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
MODEL_PEAK = PEAK_FLOPS["bf16"]


def _tower(seq: int, hidden: int, inter: int, layers: int) -> float:
    macs = 4 * seq * hidden * hidden + 2 * seq * hidden * inter \
        + 2 * seq * seq * hidden
    return 2.0 * macs * layers


def vision_tokens(cfg: dict) -> int:
    v = cfg["vision_config"]
    return (v["image_size"] // v["patch_size"]) ** 2 + 1


def image_forward_flops(cfg: dict) -> float:
    v = cfg["vision_config"]
    patches = vision_tokens(cfg) - 1
    return (_tower(vision_tokens(cfg), v["hidden_size"],
                   v["intermediate_size"], v["num_hidden_layers"])
            + 2.0 * patches * v["patch_size"] ** 2 * 3 * v["hidden_size"]
            + 2.0 * v["hidden_size"] * cfg["projection_dim"])


def text_forward_flops(cfg: dict) -> float:
    t = cfg["text_config"]
    return (_tower(t["max_position_embeddings"], t["hidden_size"],
                   t["intermediate_size"], t["num_hidden_layers"])
            + 2.0 * t["hidden_size"] * cfg["projection_dim"])


def pair_forward_flops(cfg: dict, sparc: bool = True) -> float:
    total = image_forward_flops(cfg) + text_forward_flops(cfg)
    if sparc:
        v, t = cfg["vision_config"], cfg["text_config"]
        P, T = vision_tokens(cfg), t["max_position_embeddings"]
        D = cfg["projection_dim"]
        total += 2.0 * (P * v["hidden_size"] + T * t["hidden_size"]) * D
        total += 2.0 * (2 * T * P * D + 2 * T * T * D)
    return total


def sparc_step_flops(cfg: dict, pairs: int) -> float:
    return 3.0 * pair_forward_flops(cfg, sparc=True) * pairs
