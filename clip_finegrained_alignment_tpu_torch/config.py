"""Model architecture configs of the PyTorch port.

The port's own copy of ``clip_finegrained_alignment_tpu/config.py``'s
``VisionConfig``, ``TextConfig`` and ``CLIPConfig`` (same fields, same
defaults, same named models), and of the ``PrecisionConfig`` and
``TrainConfig`` fields the training step reads (same names and defaults).
The TPU-only knobs (``remat``, ``unroll*``, ``unstack_layers``,
``use_pallas_attention``, ``use_fused_sparc``, ``quant``) are not carried:
the port always runs its kernels. Mesh and parallel fields come with the
multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class VisionConfig:
    """ViT image tower architecture."""
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # +1 for the class token

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class TextConfig:
    """Text transformer tower architecture."""
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 12
    num_heads: int = 8
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 49406
    eos_token_id: int = 49407

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class CLIPConfig:
    """Full dual-tower CLIP architecture (HF ``CLIPConfig`` fields)."""
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    projection_dim: int = 512
    logit_scale_init: float = 2.6592  # ln(1/0.07), HF CLIP default

    @staticmethod
    def vit_b32() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def vit_b16() -> "CLIPConfig":
        return CLIPConfig(vision=VisionConfig(patch_size=16))

    @staticmethod
    def vit_l14() -> "CLIPConfig":
        return CLIPConfig(
            vision=VisionConfig(
                patch_size=14, hidden_size=1024, intermediate_size=4096,
                num_layers=24, num_heads=16),
            text=TextConfig(hidden_size=768, intermediate_size=3072,
                            num_layers=12, num_heads=12),
            projection_dim=768,
        )

    @staticmethod
    def vit_l14_336() -> "CLIPConfig":
        """ViT-L/14 at 336 px: 577 vision tokens."""
        base = CLIPConfig.vit_l14()
        return replace(base, vision=replace(base.vision, image_size=336))

    @staticmethod
    def tiny_test() -> "CLIPConfig":
        """Miniature config for unit tests: same topology, tiny dims."""
        return CLIPConfig(
            vision=VisionConfig(image_size=32, patch_size=8, hidden_size=32,
                                intermediate_size=64, num_layers=2,
                                num_heads=2),
            text=TextConfig(vocab_size=256, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2,
                            max_position_embeddings=16, bos_token_id=254,
                            eos_token_id=255, pad_token_id=0),
            projection_dim=24,
        )

    @staticmethod
    def from_name(name: str) -> "CLIPConfig":
        table = {
            "ViT-B/32": CLIPConfig.vit_b32,
            "openai/clip-vit-base-patch32": CLIPConfig.vit_b32,
            "ViT-B/16": CLIPConfig.vit_b16,
            "openai/clip-vit-base-patch16": CLIPConfig.vit_b16,
            "ViT-L/14": CLIPConfig.vit_l14,
            "openai/clip-vit-large-patch14": CLIPConfig.vit_l14,
            "ViT-L/14@336": CLIPConfig.vit_l14_336,
            "openai/clip-vit-large-patch14-336": CLIPConfig.vit_l14_336,
            "tiny": CLIPConfig.tiny_test,
        }
        if name not in table:
            raise ValueError(f"Unknown CLIP model name: {name!r}. "
                             f"Known: {sorted(table)}")
        return table[name]()


@dataclass(frozen=True)
class PrecisionConfig:
    """bf16 compute with fp32 master parameters; losses reduce in fp32."""
    compute_dtype: str = "bfloat16"   # activations & matmuls
    param_dtype: str = "float32"      # master weights & optimizer state


@dataclass
class TrainConfig:
    """Training hyperparameters the train step reads (the JAX package's
    ``TrainConfig`` fields of the same names and defaults)."""
    lr: float = 1e-5
    batch_size: int = 32
    max_grad_norm: float = 1.0
    weight_decay: float = 0.2
    use_amp: bool = True                  # bf16 compute
    gradient_accumulation_steps: int = 4
    loss_type: str = "count"              # clip | sparc | count | clip_count
    similarity_threshold: float = 0.5
    global_loss_weight: float = 1.0
    local_loss_weight: float = 1.0
    inverse_temperature: float = 1.0
    optimizer_type: str = "adamw"         # adamw | adamspd
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 5e-6
    amsgrad: bool = False
    count_alpha: float = 1.0
    seed: int = 42
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)

    def __post_init__(self):
        if self.loss_type not in ("clip", "sparc", "count", "clip_count"):
            raise ValueError(f"invalid loss_type {self.loss_type!r}")
        if self.optimizer_type not in ("adamw", "adamspd"):
            raise ValueError(f"invalid optimizer_type {self.optimizer_type!r}")
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
