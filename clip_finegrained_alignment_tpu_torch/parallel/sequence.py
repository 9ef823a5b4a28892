"""Sequence (context) parallelism over the ``model`` mesh axis: the port
of ``clip_finegrained_alignment_tpu/parallel/sequence.py``.

Under ``TrainConfig.sequence_parallel`` the ``model`` axis shards the
token dim of every encoder activation ``[B, S, D]`` (the JAX package's
``P(data, model)``) and the parameters stay whole on every model rank
(no Megatron rules; ZeRO-1 and FSDP shard over ``data`` alone). The
``n`` model ranks of a data coordinate are a sequence group
(``Mesh.group("model")``); rank ``i`` holds tokens ``[i·S/n, (i+1)·S/n)``
of the sequence padded to a multiple of n (vision 197 → 198 and text
77 → 78 at n = 2):

* :func:`constrain_tokens`: an encoder's input cut to this rank's block;
  per-token work (LayerNorms, projections, MLP, residuals) then runs on
  S/n tokens.
* Attention reaches every key in one of JAX's two ways:
  :func:`gathered_attention` (GSPMD SP: the local queries against K and V
  gathered over the group, its padding dropped) or :func:`ring_attention`
  (``sp_ring``: K and V blocks hop around the group's ring under an
  online softmax, so neither is ever held whole). Both in fp32 scores:
  neither JAX path runs a Pallas kernel, and the port adds no kernel here.
* :func:`gather_tokens`: a tower's output gathered whole (padding
  dropped) before pooling, the final LayerNorm, the projections and the
  loss, which then run as ordinary replicated math on every model rank.

**The gradient rule** (every tensor counted once). Every model rank
computes the same loss from the gathered towers, so the parameters used
after the gather (post and final LayerNorms, projections,
``logit_scale``) get their whole gradient on every rank. The backward of
:func:`gather_tokens` keeps this rank's own slice of the cotangent and
does not sum the ranks' (equal) cotangents: so the parameters used before
the gather (embeddings, the vision pre-LayerNorm, every encoder layer;
``sharding_rules.before_gather``) hold this rank's part of their
gradient, and the train step sums those, and only those, over the model
group (``train/engine.py``). After that every gradient is the same on
every model rank; the norm and AdamSPD's sums count a tensor on model
rank 0 alone (``parallel/zero.py::ShardLayout.counts``). K and V gathered
for attention are another matter: many ranks' queries read them, so
their gather's backward sums the ranks' cotangents
(``collectives.all_gather_with_grad``), as the ring's hop carries each
cotangent back to the rank that sent the block.

Under ``quant="int8"`` the int8 wgrad's example rows are every rank's
token blocks: its scales take the MAX over the data × model ranks
(``mesh.py::Mesh.rows_group``), the patch embedding's too, whose input is
whole on every model rank but whose cotangent is this rank's block.

The ring's hop (:class:`_Hop`) is a ``torch.autograd.Function``: forward
the block goes to ring rank ``i + 1``, backward its cotangent to ``i − 1``
(JAX's transposed ``ppermute``), each a ``broadcast`` in the two-rank
group of the pair (gloo aborts on a ``send`` of a CUDA tensor), even ring
ranks sending first and odd ones receiving first, so that no two ranks
wait on each other.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

_NEG = -1e9


class SeqParallelSpec(NamedTuple):
    """The sequence group a forward runs over (like JAX's
    ``SeqParallelSpec``): the mesh (``parallel/mesh.py``) whose ``model``
    axis is the sequence axis, and whether attention runs the ring."""
    mesh: object
    ring: bool = False

    @property
    def size(self) -> int:
        return self.mesh.model

    @property
    def rank(self) -> int:
        return self.mesh.model_rank


def padded_len(S: int, n: int) -> int:
    """``S`` rounded up to a multiple of ``n``."""
    return -(-S // n) * n


def constrain_tokens(x: torch.Tensor, seq: Optional[SeqParallelSpec]):
    """This rank's block of a whole ``[B, S, …]`` activation: tokens
    ``[i·Sp/n, (i+1)·Sp/n)`` of the sequence zero-padded to ``Sp``."""
    if seq is None:
        return x
    n, S = seq.size, x.shape[1]
    Sl = padded_len(S, n) // n
    lo = seq.rank * Sl
    block = x[:, lo:min(lo + Sl, S)]
    if block.shape[1] < Sl:
        pad = x.new_zeros((x.shape[0], Sl - block.shape[1])
                          + tuple(x.shape[2:]))
        block = torch.cat([block, pad], dim=1)
    return block


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, S, seq):
        from .collectives import all_gather_cat
        ctx.lo, ctx.Sl = seq.rank * x.shape[1], x.shape[1]
        whole = all_gather_cat(x.transpose(0, 1).contiguous(),
                               seq.mesh.group("model"))
        return whole.transpose(0, 1)[:, :S]

    @staticmethod
    def backward(ctx, grad):
        # This rank's own slice: the ranks' cotangents are equal (module
        # docstring, the gradient rule).
        out = grad.new_zeros((grad.shape[0], ctx.Sl) + tuple(grad.shape[2:]))
        part = grad[:, ctx.lo:ctx.lo + ctx.Sl]
        out[:, :part.shape[1]] = part
        return out, None, None


def gather_tokens(x: torch.Tensor, S: int, seq: Optional[SeqParallelSpec]):
    """A tower's blocks ``[B, Sl, …]`` gathered whole over the sequence
    group, padding dropped: ``[B, S, …]``. The backward keeps this rank's
    slice (the gradient rule)."""
    if seq is None:
        return x
    return _GatherTokens.apply(x, S, seq)


def local_bias(bias: Optional[torch.Tensor], S: int, seq: SeqParallelSpec,
               device=None) -> Optional[torch.Tensor]:
    """The additive bias of this rank's query rows, in fp32. GSPMD:
    ``[Bb, 1, Sl, S]`` (None stays None). Ring: ``[Bb, 1, Sl, Sp]``, the
    pad keys at −1e9 (JAX's ``ring_attention``, ``:141-151``), None only
    when S needs no padding and there is no bias."""
    n = seq.size
    Sp = padded_len(S, n)
    Sl = Sp // n
    if bias is None and (not seq.ring or Sp == S):
        return None
    if bias is None:
        bias = torch.zeros((1, 1, S, S), dtype=torch.float32, device=device)
    bias = bias.detach().float()
    cols = Sp if seq.ring else S
    bias = torch.nn.functional.pad(bias, (0, cols - S, 0, Sp - S))
    if seq.ring and Sp != S:
        pad_keys = torch.arange(Sp, device=bias.device) >= S
        bias = bias + torch.where(pad_keys, _NEG, 0.0)[None, None, None, :]
    lo = seq.rank * Sl
    return bias[:, :, lo:lo + Sl].contiguous()


def xla_attention(q, k, v, bias, scale) -> torch.Tensor:
    """JAX's ``_xla_attention_bshd`` with fp32 scores
    (``CFA_ATTENTION_PROBS_FP32=1``) on bshd q ``[B, Sq, H, D]`` and k, v
    ``[B, Sk, H, D]``: q scaled in its dtype, scores and softmax in fp32,
    the probabilities in v's dtype times v. Returns ``[B, Sq, H, D]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if bias is not None:
        s = s + bias.float()
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def gathered_attention(q, k, v, bias, scale, S: int,
                       seq: SeqParallelSpec) -> torch.Tensor:
    """GSPMD SP's attention: this rank's queries ``[B, Sl, H, D]``
    against K and V gathered over the sequence group and cut back to the
    S real keys (:func:`xla_attention`); ``bias`` from :func:`local_bias`.
    Returns ``[B, Sl, H, D]``."""
    from .collectives import all_gather_with_grad
    kv = torch.stack([k, v]).permute(2, 0, 1, 3, 4)       # [Sl, 2, B, H, D]
    kv = all_gather_with_grad(kv.contiguous(), seq.mesh.group("model"))
    kv = kv[:S].permute(1, 2, 0, 3, 4)                     # [2, B, S, H, D]
    return xla_attention(q, kv[0], kv[1], bias, scale)


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------

def _online_softmax_step(qs, k_cur, v_cur, b_blk, carry):
    """One KV block of the running-softmax recurrence (fp32 statistics),
    JAX's ``_online_softmax_step``: qs ``[B, Sq, H, D]`` (pre-scaled);
    k_cur, v_cur ``[B, Sk, H, D]``; b_blk ``[Bb, 1, Sq, Sk]`` or None;
    carry (m, l, acc) with m, l ``[B, H, Sq, 1]`` and acc ``[B, H, Sq,
    D]``, fp32."""
    m_prev, l_prev, acc = carry
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k_cur.float())
    if b_blk is not None:
        s = s + b_blk
    m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new)
    l_new = l_prev * alpha + p.sum(-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd",
                                     p.to(v_cur.dtype).float(),
                                     v_cur.float())
    return m_new, l_new, acc


def ring_lanes(qs: Sequence[torch.Tensor], kvs: Sequence[torch.Tensor],
               biases: Sequence[Optional[torch.Tensor]],
               ranks: Sequence[int], n: int, scale: float,
               rotate: Callable[[List[torch.Tensor]], List[torch.Tensor]]
               ) -> List[torch.Tensor]:
    """The ring recurrence for the lanes this process runs: lane j is ring
    rank ``ranks[j]`` with its queries ``qs[j]`` ``[B, Sl, H, D]``, its
    K and V stacked ``kvs[j]`` ``[2, B, Sl, H, D]`` and the bias of its
    rows ``biases[j]`` ``[Bb, 1, Sl, Sp]`` (or None). At step t lane j
    holds ring rank ``(i − t) mod n``'s block, whose bias columns it adds;
    ``rotate`` moves every lane's block one rank on (lane i's to ring rank
    i + 1). Returns each lane's ``[B, Sl, H, D]`` in q's dtype."""
    states = []
    for q in qs:
        B, Sl, H, D = q.shape
        states.append((q * scale,
                       torch.full((B, H, Sl, 1), _NEG, device=q.device),
                       torch.zeros((B, H, Sl, 1), device=q.device),
                       torch.zeros((B, H, Sl, D), device=q.device)))
    blocks = list(kvs)
    for t in range(n):
        for j, (i, bias) in enumerate(zip(ranks, biases)):
            qsc, m, l, acc = states[j]
            Sl = qsc.shape[1]
            src = (i - t) % n
            b_blk = None if bias is None \
                else bias[..., src * Sl:(src + 1) * Sl]
            states[j] = (qsc,) + _online_softmax_step(
                qsc, blocks[j][0], blocks[j][1], b_blk, (m, l, acc))
        if t + 1 < n:   # the last hop would bring the blocks home unused
            blocks = rotate(blocks)
    return [(acc / l).transpose(1, 2).to(q.dtype)
            for q, (_, _, l, acc) in zip(qs, states)]


def _ring_send_recv(x: torch.Tensor, seq: SeqParallelSpec,
                    forward: bool) -> torch.Tensor:
    """``x`` to ring rank ``i + 1`` and the block of ``i − 1`` back
    (``forward``), or the reverse: two broadcasts in the pair groups,
    even ring ranks sending first."""
    from .collectives import broadcast_from
    mesh = seq.mesh
    i, n = seq.rank, seq.size
    frm = (i - 1) % n if forward else (i + 1) % n
    g_next, g_prev = mesh.group("ring_next"), mesh.group("ring_prev")
    g_to, g_frm = (g_next, g_prev) if forward else (g_prev, g_next)

    def recv():
        return broadcast_from(None, mesh.global_rank(model=frm), g_frm,
                              shape=x.shape, dtype=x.dtype, device=x.device)
    if i % 2:
        got = recv()
        broadcast_from(x, mesh.global_rank(), g_to)
        return got
    broadcast_from(x, mesh.global_rank(), g_to)
    return recv()


class _Hop(torch.autograd.Function):
    """One ring hop: forward to ring rank i + 1, backward the cotangent
    to i − 1 (JAX's transposed ``ppermute``)."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _ring_send_recv(x, seq, forward=True)

    @staticmethod
    def backward(ctx, grad):
        return _ring_send_recv(grad.contiguous(), ctx.seq,
                               forward=False), None


def ring_attention(q, k, v, bias, scale, seq: SeqParallelSpec):
    """Ring attention of this rank's blocks q, k, v ``[B, Sl, H, D]``
    (JAX's ``ring_attention``, ``parallel/sequence.py:91-200``, on the
    blocks a rank holds): the local queries' online softmax over the n
    K/V blocks as they hop around the sequence group, one block a step;
    ``bias`` from :func:`local_bias` (``[Bb, 1, Sl, Sp]``, the pad keys at
    −1e9). Returns ``[B, Sl, H, D]`` in q's dtype."""
    kv = torch.stack([k, v])
    return ring_lanes([q], [kv], [bias], [seq.rank], seq.size, scale,
                      lambda blocks: [_Hop.apply(blocks[0], seq)])[0]


def attention(q, k, v, bias, scale, S: int, seq: SeqParallelSpec):
    """An encoder layer's attention under sequence parallelism: this
    rank's blocks q, k, v ``[B, Sl, H, D]`` of an S-token sequence and the
    bias of its rows (:func:`local_bias`), through :func:`ring_attention`
    with ``seq.ring``, else :func:`gathered_attention`."""
    if seq.ring:
        Sl = q.shape[1]
        lo = seq.rank * Sl
        if lo + Sl > S:
            # This block holds pad tokens: their keys and values are
            # zeros, as JAX's ring pads q, k and v (a fully masked row
            # weighs the pad keys too, at −1e9 like the rest).
            pad = (torch.arange(lo, lo + Sl, device=k.device)
                   >= S)[None, :, None, None]
            k, v = k.masked_fill(pad, 0), v.masked_fill(pad, 0)
        return ring_attention(q, k, v, bias, scale, seq)
    return gathered_attention(q, k, v, bias, scale, S, seq)
