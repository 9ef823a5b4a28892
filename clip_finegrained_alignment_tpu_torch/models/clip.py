"""CLIP dual tower in PyTorch, the port of ``clip_finegrained_alignment_tpu/
models/clip.py``.

Parameters carry HF ``CLIPModel`` names (``vision_model.pre_layrnorm``
spelling included), so an HF-named state dict loads with ``strict=True``
once its ``position_ids`` buffers are dropped. The modules hold the
parameters; the arithmetic is in plain functions that follow the JAX
package's numerics step by step, with explicit casts (no autocast):

* ``linear`` casts x and the weight to the compute dtype, multiplies, then
  adds the bias cast to the product's dtype (``clip.py:198-206``);
* ``layer_norm`` takes statistics and applies scale and bias in fp32, then
  casts back (``clip.py:184-195``);
* ``quick_gelu`` multiplies by 1.702 rounded to x's dtype, as JAX's weakly
  typed Python scalar does;
* the residual stream stays in the compute dtype;
* the patch embedding is patchify + matmul (``clip.py:492-503``), so no
  cuDNN convolution (and no TF32) is involved;
* attention is ``ops/attention.py::flash_attention`` on bshd views of the
  projections, with the text tower's causal bias at the finite -1e9;
* with ``quant`` ``"switchback"`` or ``"int8"`` (``TrainConfig.quant``),
  every encoder-layer projection (q, k, v, out, fc1, fc2) and the vision
  patch embedding go through ``ops/quant.py::quant_linear`` (dynamic
  int8, ``_linear_fn``); the loss-facing ``visual_projection`` and
  ``text_projection`` and the [S, S] attention stay exact, as in JAX
  (``clip.py:209-218``). A model built for global negatives
  (``build_train_model(..., global_negatives=True)`` on a mesh) holds the
  group over which a train microbatch's rows are split
  (``parallel/mesh.py::Mesh.rows_group``): its int8 wgrads take their
  scales over it, as JAX's GSPMD step does.

:meth:`CLIPModel.cast_matmul_weights` casts every weight except the
LayerNorms and ``logit_scale`` to the compute dtype once, at load; the
casts in the functions are then no-ops and the numbers are unchanged.
Training (:func:`build_train_model`) keeps fp32 master parameters and lets
the per-call casts run, as the JAX package does; their gradients flow back
through the casts to fp32.

Tensor and pipeline parallelism (``build_train_model(..., mesh=...)``
with ``mesh.model`` or ``mesh.pipe`` above 1; ``parallel/``): the model
holds this rank's part, under the whole model's HF names.

* **TP** (``parallel/sharding_rules.py::tp_dim``): q, k, v and fc1 are
  column-parallel (their weight's and bias's rows split), out_proj and fc2
  row-parallel (their weight's columns split; the bias whole, added once
  after the all-reduce). A rank runs H/tp heads at the same head dim,
  between Megatron's ``copy_to_model`` and ``reduce_from_model``
  (``parallel/collectives.py``). Under ``quant`` the contraction a TP
  layer splits takes its scales over the model group, as JAX's GSPMD
  step does (``ops/quant.py``, :class:`~..ops.quant.Groups`): a
  row-parallel layer's forward sums its int32 partial products over the
  ranks and dequantizes once with the bias (in place of
  ``reduce_from_model``); a column-parallel layer's dgrad sums its int32
  partial dx, so its input skips ``copy_to_model``, whose backward would
  sum dx a second time.
* **PP** (``parallel/pipeline.py``): each tower's encoder holds layers
  ``[s·L/K, (s+1)·L/K)`` of stage s (an ``nn.ModuleDict`` keyed by the
  global layer index, so the names stay the whole model's) and runs them
  in the GPipe schedule; only stage 0 computes the embeddings.
* **SP** (``seq``, a ``parallel/sequence.py::SeqParallelSpec``, passed
  to :func:`clip_forward`, :func:`encode_image` and :func:`encode_text` as
  JAX passes it): the parameters are whole; each encoder runs on this
  rank's block of the tokens (the embeddings are computed whole and cut),
  its attention reaching every key through K and V gathered over the
  sequence group or the ring, in fp32 scores (no kernel: neither JAX path
  runs a Pallas kernel), and each tower's output is gathered whole before
  pooling.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPConfig, TextConfig, VisionConfig
from ..ops.attention import flash_attention
from ..ops.quant import LOCAL, Groups, quant_linear

# Large negative additive bias (never -inf: no NaN in fully-masked rows).
_NEG_INF = -1e9


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    there is none (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------

def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """HF CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(x * float(torch.tensor(1.702, dtype=x.dtype)))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with fp32 statistics, scale and bias; returns x's dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """x @ Wᵀ in ``dtype``, then + bias cast to the product's dtype."""
    y = x.to(dtype) @ weight.to(dtype).t()
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _linear_fn(quant: str, groups: Groups = LOCAL):
    """The projection GEMM for a ``TrainConfig.quant`` mode, with
    :func:`linear`'s signature: :func:`linear` itself for ``"none"``, the
    dynamic int8 product (``ops/quant.py``) otherwise, its scales over
    ``groups`` (:func:`_groups`)."""
    if quant == "none":
        return linear
    return lambda x, weight, bias, dtype: quant_linear(x, weight, bias,
                                                       dtype, quant, groups)


def _apply(lin: nn.Linear, x: torch.Tensor, dtype,
           quant: str = "none", groups: Groups = LOCAL) -> torch.Tensor:
    return _linear_fn(quant, groups)(x, lin.weight, lin.bias, dtype)


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] NHWC → [B, num_patches, p²·3], flattened in (row in
    patch, column in patch, channel) order."""
    B, H, W, C = pixel_values.shape
    p = patch_size
    x = pixel_values.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def patch_kernel(conv_weight: torch.Tensor) -> torch.Tensor:
    """HF conv weight [D, 3, p, p] → the [D, p·p·3] matrix that
    :func:`patchify`'s rows multiply (as a linear weight)."""
    D = conv_weight.shape[0]
    return conv_weight.permute(0, 2, 3, 1).reshape(D, -1)


# ---------------------------------------------------------------------------
# Modules (parameter containers with HF names)
# ---------------------------------------------------------------------------

class TP(NamedTuple):
    """A rank's tensor-parallel share: its process group of ``size``."""
    group: object
    size: int

    @property
    def quant_group(self):
        """The group as ``ops/quant.py`` takes it (None there means no
        group: the default group is named)."""
        import torch.distributed as dist
        return dist.group.WORLD if self.group is None else self.group


def _quantized(quant: str) -> bool:
    """Whether the projections are quantized, and so take the scales of
    the dimensions the ranks split (:func:`_groups`)."""
    return quant != "none"


def _groups(quant: str, tp: Optional[TP], rows, split: str = "") -> Groups:
    """The groups a quantized product's scales reduce over
    (``ops/quant.py::Groups``): ``rows``, the group holding the parts of
    the microbatch's rows (the int8 wgrad's), and under TP the model group
    for the contraction this layer splits (``split``: ``"k"``, the
    forward's, for a row-parallel layer; ``"n"``, the dgrad's, for a
    column-parallel one)."""
    if not _quantized(quant):
        return LOCAL
    split = {split: tp.quant_group} if tp is not None and split else {}
    return Groups(m=rows, **split)


def _column_input(x, tp: Optional[TP], quant="none"):
    """A column-parallel layer's input: under TP, through
    ``copy_to_model`` (its backward sums dx over the shards), unless the
    layer is quantized: its dgrad sums the shards' dx itself."""
    if tp is not None and not _quantized(quant):
        from ..parallel.collectives import copy_to_model
        x = copy_to_model(x, tp.group)
    return x


def _column(lin: nn.Linear, x, dtype, quant, tp: Optional[TP], rows):
    """A column-parallel layer: under TP and ``quant``, its dgrad's
    contraction (the output features) is split over the model ranks."""
    return _apply(lin, x, dtype, quant, _groups(quant, tp, rows, "n"))


def _row(lin: nn.Linear, x, dtype, quant, tp: Optional[TP], rows):
    """A row-parallel layer: under TP the partial product summed over the
    model ranks, then the whole bias, once (quantized: the int32 partial
    sums summed, one dequant with the bias)."""
    if tp is None or _quantized(quant):
        return _apply(lin, x, dtype, quant, _groups(quant, tp, rows, "k"))
    from ..parallel.collectives import reduce_from_model
    y = reduce_from_model(_linear_fn(quant)(x, lin.weight, None, dtype),
                          tp.group)
    return y + lin.bias.to(y.dtype)


class Attention(nn.Module):
    def __init__(self, d: int, num_heads: int, tp: Optional[TP] = None,
                 rows=None):
        super().__init__()
        n = 1 if tp is None else tp.size
        self.tp, self.rows = tp, rows
        self.num_heads = num_heads // n     # this rank's heads
        self.q_proj = nn.Linear(d, d // n)
        self.k_proj = nn.Linear(d, d // n)
        self.v_proj = nn.Linear(d, d // n)
        self.out_proj = nn.Linear(d // n, d)

    def forward(self, x, bias, dtype, quant="none", seq=None, seq_len=0):
        """``seq``: ``x`` is this rank's block of a ``seq_len``-token
        sequence and ``bias`` its rows' (``sequence.local_bias``)."""
        x = _column_input(x, self.tp, quant)
        B, S, _ = x.shape
        H = self.num_heads
        D = self.q_proj.weight.shape[0]     # this rank's H heads
        heads = (lambda y: y.view(B, S, H, D // H))
        q, k, v = (heads(_column(lin, x, dtype, quant, self.tp, self.rows))
                   for lin in (self.q_proj, self.k_proj, self.v_proj))
        if seq is None:
            out = flash_attention(q, k, v, bias, (D // H) ** -0.5)
        else:
            from ..parallel.sequence import attention
            out = attention(q, k, v, bias, (D // H) ** -0.5, seq_len, seq)
        return _row(self.out_proj, out.reshape(B, S, D), dtype, quant,
                    self.tp, self.rows)


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, tp: Optional[TP] = None,
                 rows=None):
        super().__init__()
        n = 1 if tp is None else tp.size
        self.tp, self.rows = tp, rows
        self.fc1 = nn.Linear(d, d_ff // n)
        self.fc2 = nn.Linear(d_ff // n, d)

    def forward(self, x, dtype, quant="none"):
        x = _column_input(x, self.tp, quant)
        h = quick_gelu(_column(self.fc1, x, dtype, quant, self.tp,
                               self.rows))
        return _row(self.fc2, h, dtype, quant, self.tp, self.rows)


class EncoderLayer(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(·))."""

    def __init__(self, d: int, d_ff: int, num_heads: int, eps: float,
                 tp: Optional[TP] = None, rows=None):
        super().__init__()
        self.self_attn = Attention(d, num_heads, tp, rows)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = MLP(d, d_ff, tp, rows)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x, bias, dtype, quant="none", seq=None, seq_len=0):
        x = x + self.self_attn(layer_norm(self.layer_norm1, x), bias, dtype,
                               quant, seq, seq_len)
        return x + self.mlp(layer_norm(self.layer_norm2, x), dtype, quant)


class Encoder(nn.Module):
    """The layer stack, in an ``nn.ModuleDict`` keyed by the global layer
    index (HF's names). ``tp``: tensor-parallel layers. ``pipeline``
    (``parallel/pipeline.py::GPipe``): only this stage's layers, run in
    its schedule. ``rows``: the group holding the parts of a microbatch's
    rows (:func:`_groups`)."""

    def __init__(self, d, d_ff, num_heads, eps, num_layers,
                 tp: Optional[TP] = None, pipeline=None, rows=None):
        super().__init__()
        self.pipeline = pipeline
        per, lo = num_layers, 0
        if pipeline is not None:
            per = num_layers // pipeline.stages
            lo = pipeline.stage * per
        self.layers = nn.ModuleDict(
            {str(i): EncoderLayer(d, d_ff, num_heads, eps, tp, rows)
             for i in range(lo, lo + per)})

    def _run(self, x, bias, dtype, quant, seq=None, seq_len=0):
        for layer in self.layers.values():
            x = layer(x, bias, dtype, quant, seq, seq_len)
        return x

    def forward(self, x, bias, dtype, quant="none", shape=None, seq=None):
        """``x`` [B, S, D] (under a pipeline: the embeddings on stage 0,
        None on the others, and ``shape`` the rows' [B, S, D]). ``seq``:
        the stack runs on this rank's block of the tokens, which it
        returns (``parallel/sequence.py``)."""
        if seq is not None:
            from ..parallel.sequence import constrain_tokens, local_bias
            S = x.shape[1]
            return self._run(constrain_tokens(x, seq),
                             local_bias(bias, S, seq, x.device), dtype,
                             quant, seq, S)
        if self.pipeline is None:
            return self._run(x, bias, dtype, quant)
        return self.pipeline.run(
            lambda h, b: self._run(h, b, dtype, quant), x, bias, shape,
            dtype, bias.device if bias is not None else
            next(self.parameters()).device)


class TowerOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # [B, S, D] (vision: before post-LN)
    pooled: torch.Tensor             # [B, D]


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        p = cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, p, stride=p,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.position_embedding = nn.Embedding(cfg.seq_len, cfg.hidden_size)


def _embeds(pipeline) -> bool:
    """Whether this rank computes the embeddings: all but the pipeline's
    later stages."""
    return pipeline is None or pipeline.first


class VisionTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig, tp: Optional[TP] = None,
                 pipeline=None, rows=None):
        super().__init__()
        self.cfg = cfg
        self.rows = rows
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.embeddings = VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(d, eps=eps)  # HF's spelling
        self.encoder = Encoder(d, cfg.intermediate_size, cfg.num_heads, eps,
                               cfg.num_layers, tp, pipeline, rows)
        self.post_layernorm = nn.LayerNorm(d, eps=eps)

    def forward(self, pixel_values, dtype, quant="none",
                seq=None) -> TowerOutput:
        """``pixel_values``: [B, H, W, 3] NHWC, normalized. ``seq``:
        sequence parallelism (``parallel/sequence.py``)."""
        e = self.embeddings
        x = None
        if _embeds(self.encoder.pipeline):
            x = patchify(pixel_values.to(dtype), self.cfg.patch_size)
            # Whole on every model rank; its rows are split as the
            # encoder's are (under SP its cotangent is this rank's block).
            x = _linear_fn(quant, _groups(quant, None, self.rows))(
                x, patch_kernel(e.patch_embedding.weight), None, dtype)
            cls = e.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1)
            x = x + e.position_embedding.weight.to(dtype)[None]
            x = layer_norm(self.pre_layrnorm, x)
        x = self.encoder(x, None, dtype, quant,
                         shape=(pixel_values.shape[0], self.cfg.seq_len,
                                self.cfg.hidden_size), seq=seq)
        if seq is not None:
            from ..parallel.sequence import gather_tokens
            x = gather_tokens(x, self.cfg.seq_len, seq)
        pooled = layer_norm(self.post_layernorm, x[:, 0])
        return TowerOutput(last_hidden_state=x, pooled=pooled)


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


def text_attention_bias(seq_len: int, attention_mask: Optional[torch.Tensor],
                        device) -> torch.Tensor:
    """Causal + optional padding additive bias, fp32 [B or 1, 1, S, S]."""
    causal = torch.full((seq_len, seq_len), _NEG_INF, dtype=torch.float32,
                        device=device).triu(1)
    bias = causal[None, None]
    if attention_mask is not None:
        pad = (1.0 - attention_mask.to(torch.float32)) * _NEG_INF
        bias = bias + pad[:, None, None, :]
    return bias


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig, tp: Optional[TP] = None,
                 pipeline=None, rows=None):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = Encoder(d, cfg.intermediate_size, cfg.num_heads, eps,
                               cfg.num_layers, tp, pipeline, rows)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, input_ids, dtype, attention_mask=None,
                quant="none", seq=None) -> TowerOutput:
        """``input_ids``: [B, T] int. Pools the hidden state at the FIRST
        EOS token, as HF does. ``seq``: sequence parallelism."""
        e = self.embeddings
        B, T = input_ids.shape
        ids = input_ids.long()
        x = None
        if _embeds(self.encoder.pipeline):
            x = F.embedding(ids, e.token_embedding.weight.to(dtype))
            x = x + e.position_embedding.weight.to(dtype)[None, :T]
        bias = text_attention_bias(T, attention_mask, ids.device)
        x = self.encoder(x, bias, dtype, quant,
                         shape=(B, T, self.cfg.hidden_size), seq=seq)
        if seq is not None:
            from ..parallel.sequence import gather_tokens
            x = gather_tokens(x, T, seq)
        x = layer_norm(self.final_layer_norm, x)
        eos_pos = (ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eos_pos]
        return TowerOutput(last_hidden_state=x, pooled=pooled)


class CLIPOutput(NamedTuple):
    """As HF ``CLIPModel.forward``: the ``*_embeds`` are L2-normalized."""
    image_embeds: torch.Tensor            # [B, P]
    text_embeds: torch.Tensor             # [Bt, P]
    logits_per_image: torch.Tensor        # [B, Bt]
    logits_per_text: torch.Tensor         # [Bt, B]
    vision_last_hidden_state: torch.Tensor
    text_last_hidden_state: torch.Tensor
    vision_pooled: torch.Tensor
    text_pooled: torch.Tensor


class CLIPModel(nn.Module):
    def __init__(self, cfg: CLIPConfig, tp: Optional[TP] = None,
                 pipeline=None, rows=None):
        """``tp``, ``pipeline``: this rank's tensor-parallel share and
        pipeline schedule; ``rows``: the group holding the parts of a
        train microbatch's rows (:func:`build_train_model` with a mesh)."""
        super().__init__()
        self.cfg = cfg
        self.pipeline = pipeline
        self.rows = rows
        self.vision_model = VisionTransformer(cfg.vision, tp, pipeline, rows)
        self.text_model = TextTransformer(cfg.text, tp, pipeline, rows)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size,
                                           cfg.projection_dim, bias=False)
        self.text_projection = nn.Linear(cfg.text.hidden_size,
                                         cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))

    def cast_matmul_weights(self, dtype: torch.dtype) -> "CLIPModel":
        """Cast every parameter but the LayerNorms' and ``logit_scale`` to
        ``dtype`` in place: what the forward would cast on every call."""
        keep = {id(p) for m in self.modules() if isinstance(m, nn.LayerNorm)
                for p in m.parameters()}
        keep.add(id(self.logit_scale))
        for p in self.parameters():
            if id(p) not in keep:
                p.data = p.data.to(dtype)
        return self


def encode_image(model: CLIPModel, pixel_values: torch.Tensor, *,
                 dtype=torch.float32, quant="none", seq=None) -> torch.Tensor:
    """Projected image embedding (not normalized), in ``dtype``."""
    out = model.vision_model(pixel_values, dtype, quant, seq)
    return _apply(model.visual_projection, out.pooled, dtype)


def encode_text(model: CLIPModel, input_ids: torch.Tensor, *,
                attention_mask=None, dtype=torch.float32,
                quant="none", seq=None) -> torch.Tensor:
    """Projected text embedding (not normalized), in ``dtype``."""
    out = model.text_model(input_ids, dtype, attention_mask, quant, seq)
    return _apply(model.text_projection, out.pooled, dtype)


def clip_forward(model: CLIPModel, pixel_values: torch.Tensor,
                 input_ids: torch.Tensor, *, attention_mask=None,
                 dtype=torch.float32, quant="none", seq=None) -> CLIPOutput:
    """Both towers; normalization and logits in fp32 (unguarded norm).
    ``quant`` picks the encoder projections' GEMM (:func:`_linear_fn`);
    ``seq``: sequence parallelism (``parallel/sequence.py``)."""
    v = model.vision_model(pixel_values, dtype, quant, seq)
    t = model.text_model(input_ids, dtype, attention_mask, quant, seq)
    ie = _apply(model.visual_projection, v.pooled, dtype).float()
    te = _apply(model.text_projection, t.pooled, dtype).float()
    ie = ie / ie.norm(dim=-1, keepdim=True)
    te = te / te.norm(dim=-1, keepdim=True)
    logits_per_text = clip_logits(model, ie, te)
    return CLIPOutput(
        image_embeds=ie, text_embeds=te,
        logits_per_image=logits_per_text.t(),
        logits_per_text=logits_per_text,
        vision_last_hidden_state=v.last_hidden_state,
        text_last_hidden_state=t.last_hidden_state,
        vision_pooled=v.pooled, text_pooled=t.pooled)


def clip_logits(model: CLIPModel, image_embeds: torch.Tensor,
                text_embeds: torch.Tensor) -> torch.Tensor:
    """``logits_per_text`` [Bt, B] of normalized fp32 embeddings, scaled by
    ``exp(logit_scale)``."""
    return (text_embeds @ image_embeds.t()) * model.logit_scale.float().exp()


def sparc_embeddings(model: CLIPModel, out: CLIPOutput, *,
                     dtype=torch.float32):
    """Both towers' full hidden sequences projected into the shared space
    (the SPARC input): (v_patch_embed [B, S_v, P], l_token_embed
    [B, T, P]) in ``dtype``. The vision sequence is taken before the
    post-LayerNorm and keeps the class token."""
    v = _apply(model.visual_projection, out.vision_last_hidden_state, dtype)
    l = _apply(model.text_projection, out.text_last_hidden_state, dtype)
    return v, l


def _load(cfg: CLIPConfig, state_dict, dev, tp: Optional[TP] = None,
          pipeline=None, mesh=None, copy: bool = False,
          rows=None) -> CLIPModel:
    """A :class:`CLIPModel` (this rank's part under ``tp`` / ``pipeline``)
    built on the meta device and given ``state_dict``'s tensors, on
    ``dev`` in fp32; with ``copy``, copies of this rank's parts of them
    (:func:`local_state`)."""
    with torch.device("meta"):
        model = CLIPModel(cfg, tp, pipeline, rows)
    if copy:
        state_dict = local_state(model, state_dict, mesh)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.to(device=dev, dtype=torch.float32)


def build_train_model(cfg: CLIPConfig, state_dict, *,
                      device="cuda", mesh=None, num_micro: int = 0,
                      global_negatives: bool = False) -> CLIPModel:
    """A trainable :class:`CLIPModel` holding a copy of ``state_dict``
    (HF names, ``strict=True``) on ``device``: fp32 master parameters that
    require grad, never cast (the forward casts per call). The optimizer
    updates them in place, so they never alias the caller's tensors.

    ``mesh`` with ``model`` or ``pipe`` above 1 (``parallel/mesh.py``):
    the whole ``state_dict`` is cut down to this rank's tensor-parallel
    shards and pipeline stage (:func:`local_state`); ``num_micro``: the
    pipeline's microbatches an encoder call
    (``parallel/pipeline.py::default_num_micro``). ``global_negatives``
    (on a mesh): the step is one program over the mesh's ranks, so the
    int8 wgrads take their scales over every rank that holds a part of a
    microbatch's rows (``parallel/mesh.py::Mesh.rows_group``); without
    it each rank's rows are its own (local negatives)."""
    tp = pipeline = rows = None
    if mesh is not None and mesh.tensor_parallel:
        tp = TP(mesh.group("model"), mesh.model)
    if mesh is not None and mesh.pipe > 1:
        from ..parallel.pipeline import GPipe, default_num_micro
        pipeline = GPipe(mesh, default_num_micro(mesh.pipe, num_micro))
    if mesh is not None and global_negatives:
        rows = mesh.rows_group()
    model = _load(cfg, state_dict, resolve_device(device), tp, pipeline,
                  mesh, copy=True, rows=rows)
    return model.requires_grad_(True).train()


def local_state(model: CLIPModel, state_dict, mesh) -> dict:
    """Copies of the entries of a whole (HF-named) ``state_dict`` that
    ``model`` (this rank's part) holds, each cut to this rank's
    tensor-parallel shard; all of them, whole, without tensor or pipeline
    parallelism (so that ``strict`` loading still sees every key)."""
    from ..parallel.sharding_rules import tp_dim
    if mesh is None or (not mesh.tensor_parallel and mesh.pipe == 1):
        return {k: v.detach().clone() for k, v in state_dict.items()}
    out = {}
    for name in model.state_dict():
        t = state_dict[name].detach()
        d = tp_dim(name) if mesh.tensor_parallel else None
        if d is not None:
            t = t.chunk(mesh.model, d)[mesh.model_rank]
        out[name] = t.clone()
    return out


def build_model(cfg: CLIPConfig, state_dict, *, device="cuda",
                dtype: torch.dtype = torch.float32) -> CLIPModel:
    """A :class:`CLIPModel` holding ``state_dict`` (HF names, loaded with
    ``strict=True``) on ``device``, frozen, its matmul weights in
    ``dtype``."""
    model = _load(cfg, state_dict, resolve_device(device))
    model.requires_grad_(False).eval()
    return model.cast_matmul_weights(dtype)
