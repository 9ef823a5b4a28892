"""Model architecture configs of the PyTorch port.

The port's own copy of ``clip_finegrained_alignment_tpu/config.py``'s
``VisionConfig``, ``TextConfig`` and ``CLIPConfig`` (same fields, same
defaults, same named models), and of the ``PrecisionConfig`` and
``TrainConfig`` fields the train step, the trainer and the training CLI
read (same names and defaults), ``grad_cache``, ``quant``, ``mesh`` and
the parallel fields among them. Not carried: the TPU-only knobs
(``remat``, ``unroll*``, ``unstack_layers``, ``use_pallas_attention``,
``use_fused_sparc``), since the port always runs its kernels.

``mesh`` lays the processes (one a GPU, ``parallel/mesh.py``) out as
``data × model × pipe``: data-parallel, tensor-parallel and pipeline
ranks; ``pipeline_microbatches`` is the GPipe split of a train
microbatch (``parallel/pipeline.py``). ``sequence_parallel`` makes the
``model`` axis the sequence axis (GSPMD SP, or the ring with ``sp_ring``;
``parallel/sequence.py``).
"""

from __future__ import annotations

import dataclasses
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
class MeshConfig:
    """The process layout: ``data`` data-parallel ranks (batch-sharded),
    ``model`` tensor-parallel ranks (Megatron splits of the encoder
    layers) and ``pipe`` pipeline stages (GPipe over the encoder
    layers)."""
    data: int = 1
    model: int = 1
    pipe: int = 1


@dataclass(frozen=True)
class PrecisionConfig:
    """bf16 compute with fp32 master parameters; losses reduce in fp32."""
    compute_dtype: str = "bfloat16"   # activations & matmuls
    param_dtype: str = "float32"      # master weights & optimizer state


@dataclass
class TrainConfig:
    """Training hyperparameters (the JAX package's ``TrainConfig`` fields
    of the same names and defaults, without the TPU knobs)."""
    lr: float = 1e-5
    batch_size: int = 32
    max_grad_norm: float = 1.0
    warmup_steps: int = 1000
    max_epochs: int = 400
    save_every: int = 1
    weight_decay: float = 0.2
    use_amp: bool = True                  # bf16 compute
    clip_model: str = "ViT-B/32"
    max_length: int = 77
    experiment_name: str = "clip_default"
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
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_dir: str = "checkpoints"
    log_every: int = 10
    # One contrastive loss over the whole batch_size x accum pool at one
    # chunk's activation memory (train/gradcache.py); clip and sparc only.
    grad_cache: bool = False
    # Dynamic int8 for the encoder projection GEMMs (ops/quant.py):
    # "switchback" = int8 forward and dgrad, exact wgrad
    # (arXiv:2304.13013); "int8" = all three products int8. Changes the
    # numerics (bounded: tests/test_torch_quant.py); not a parity mode.
    quant: str = "none"
    # Data parallelism (train/engine.py). False: each rank's loss sees its
    # own rows, gradients are averaged (DDP). True: the contrastive terms
    # see the global batch through a gradient-carrying all-gather.
    global_negatives: bool = False
    zero1: bool = False                   # optimizer state sharded over data
    fsdp: bool = False                    # parameters too; needs
    #                                       global_negatives, excludes zero1
    # GPipe microbatches a train microbatch under mesh.pipe > 1 (0 = 2 x
    # the stages; parallel/pipeline.py).
    pipeline_microbatches: int = 0
    # Sequence parallelism over mesh.model (parallel/sequence.py): the
    # token dim of the encoders' activations split over the model ranks,
    # the parameters whole on each; sp_ring: attention as ring attention
    # (without sequence_parallel it does nothing, as in JAX).
    sequence_parallel: bool = False
    sp_ring: bool = False

    def __post_init__(self):
        if self.loss_type not in ("clip", "sparc", "count", "clip_count"):
            raise ValueError(f"invalid loss_type {self.loss_type!r}")
        if self.optimizer_type not in ("adamw", "adamspd"):
            raise ValueError(f"invalid optimizer_type {self.optimizer_type!r}")
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        if self.quant not in ("none", "switchback", "int8"):
            raise ValueError(f"invalid quant {self.quant!r} "
                             "(none | switchback | int8)")

    @property
    def effective_batch_size(self) -> int:
        return self.batch_size * self.gradient_accumulation_steps

    def model_config(self) -> CLIPConfig:
        return CLIPConfig.from_name(self.clip_model)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["betas"] = list(d["betas"])
        return d

    @staticmethod
    def from_dict(d: dict) -> "TrainConfig":
        """Inverse of :meth:`to_dict`; keys this config does not have (the
        JAX package's TPU fields) are dropped."""
        d = dict(d)
        if "betas" in d:
            d["betas"] = tuple(d["betas"])
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = MeshConfig(**d["mesh"])
        if isinstance(d.get("precision"), dict):
            known = {f.name for f in dataclasses.fields(PrecisionConfig)}
            d["precision"] = PrecisionConfig(
                **{k: v for k, v in d["precision"].items() if k in known})
        known = {f.name for f in dataclasses.fields(TrainConfig)}
        return TrainConfig(**{k: v for k, v in d.items() if k in known})

    def print_config(self) -> None:
        """The configuration report, grouped as the JAX package prints it."""
        print("\n" + "=" * 50)
        print("TRAINING CONFIGURATION")
        print("=" * 50)
        sparc = self.loss_type == "sparc"
        groups = {
            "Training Hyperparameters": {
                "Learning Rate": self.lr,
                "Batch Size": self.batch_size,
                "Gradient Accumulation Steps": self.gradient_accumulation_steps,
                "Effective Batch Size": self.effective_batch_size,
                "Max Gradient Norm": self.max_grad_norm,
                "Warmup Steps": self.warmup_steps,
                "Weight Decay": self.weight_decay,
                "Mixed Precision": self.use_amp,
            },
            "Model Configuration": {
                "CLIP Model": self.clip_model,
                "Max Token Length": self.max_length,
                "Experiment Name": self.experiment_name,
                "Loss Type": self.loss_type,
            },
            "Loss Parameters": {
                "Count Alpha": self.count_alpha
                if "count" in self.loss_type else "N/A",
                "Similarity Threshold": self.similarity_threshold
                if sparc else "N/A",
                "Global Loss Weight": self.global_loss_weight
                if sparc else "N/A",
                "Local Loss Weight": self.local_loss_weight
                if sparc else "N/A",
                "Inverse Temperature": self.inverse_temperature,
            },
            "Optimizer Configuration": {
                "Type": self.optimizer_type,
                "Betas": self.betas,
                "Epsilon": self.eps,
                "AMSGrad": self.amsgrad,
            },
            "Precision": {
                "Compute dtype": self.precision.compute_dtype
                if self.use_amp else "float32",
                "Parameter dtype": self.precision.param_dtype,
                "GradCache (full-pool negatives)": self.grad_cache,
                "Int8 quantized GEMMs": self.quant,
            },
            "Data Parallelism": {
                "Ranks (mesh.data)": self.mesh.data,
                "Global negatives": self.global_negatives,
                "ZeRO-1": self.zero1,
                "FSDP": self.fsdp,
                "Sequence parallel": (("ring" if self.sp_ring else "gspmd")
                                      if self.sequence_parallel else False),
            },
        }
        for group, params in groups.items():
            print(f"\n{group}:")
            for k, v in params.items():
                print(f"  {k}: {v}")
        print("\n" + "=" * 50 + "\n")
