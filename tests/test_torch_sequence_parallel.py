"""The port's sequence parallelism (``clip_finegrained_alignment_tpu_torch/
parallel/sequence.py``) against the JAX package's
(``parallel/sequence.py``, ``models/clip.py::_xla_attention_bshd``), on
the CPU, from the same numpy inputs: the mirror of JAX's
``tests/test_sequence_parallel.py`` for the ops and the refusals.

The ring runs here in one process: n lanes, one a ring rank, each with
its own block of q, k and v (``constrain_tokens``) and of the bias's rows
(``local_bias``), the blocks rotated one rank on a step by a list
rotation (``ring_lanes``, the recurrence the ranks run with a real hop).
The real hop, and the SP train steps against JAX's mesh step and one
process, run in ``tests/test_torch_model_parallel.py``'s spawns.

Tolerances are JAX's own: forward rtol 2e-5 / atol 2e-6, gradients rtol
3e-5 / atol 3e-6, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_workers as W
from clip_finegrained_alignment_tpu.config import (
    CLIPConfig as JaxCLIPConfig, MeshConfig as JaxMeshConfig,
    TrainConfig as JaxTrainConfig)
from clip_finegrained_alignment_tpu.models import clip as jm
from clip_finegrained_alignment_tpu.models.clip import (
    _text_attention_bias, _xla_attention_bshd)
from clip_finegrained_alignment_tpu.optim.factory import \
    make_optimizer as jax_make_optimizer
from clip_finegrained_alignment_tpu.parallel import mesh as jmesh
from clip_finegrained_alignment_tpu.parallel.sequence import \
    ring_attention as jax_ring_attention
from clip_finegrained_alignment_tpu.train.engine import \
    make_train_step as jax_make_train_step
from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                         MeshConfig)
from clip_finegrained_alignment_tpu_torch.parallel import sequence as sq
from clip_finegrained_alignment_tpu_torch.parallel.mesh import Mesh
from clip_finegrained_alignment_tpu_torch.train import engine

N = 4
FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=3e-5, atol=3e-6)


def _spec(i, n=N, ring=True):
    return sq.SeqParallelSpec(Mesh(data=1, rank=i, device=torch.device(
        "cpu"), model=n, sequence_parallel=True), ring=ring)


def ring_one_process(q, k, v, bias, scale, n=N):
    """The port's ring attention of whole bshd q, k, v over n lanes in
    this process: each lane ring rank i's blocks, rotated by a list
    rotation; the lanes' outputs put back whole (padding dropped)."""
    S = q.shape[1]
    specs = [_spec(i, n) for i in range(n)]
    qs = [sq.constrain_tokens(q, s) for s in specs]
    kvs = [torch.stack([sq.constrain_tokens(k, s),
                        sq.constrain_tokens(v, s)]) for s in specs]
    biases = [sq.local_bias(bias, S, s) for s in specs]
    out = sq.ring_lanes(qs, kvs, biases, list(range(n)), n, scale,
                        lambda blocks: blocks[-1:] + blocks[:-1])
    return torch.cat(out, dim=1)[:, :S]


def _inputs(S, with_bias, seed):
    rng = np.random.default_rng(seed)
    B, H, D = 2, 2, 8
    q, k, v, w = (rng.normal(size=(B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    bias = None
    if with_bias:   # causal, and key padding on the last keys of sample 1
        ids = np.full((B, S), 7, np.int32)
        mask = np.ones((B, S), np.int32)
        mask[1, S - 3:] = 0
        bias = np.asarray(_text_attention_bias(jnp.asarray(ids),
                                               jnp.asarray(mask), S))
    return q, k, v, w, bias, D ** -0.5


def _sp_mesh(devices):
    return jmesh.make_mesh(JaxMeshConfig(data=2, model=N), devices)


@pytest.mark.parametrize("S,with_bias", [(16, False), (16, True),
                                         (13, False), (13, True)])
def test_ring_attention_matches_jax(S, with_bias, eight_devices):
    """Forward and gradients of q, k, v at divisible (16/4) and padded
    (13 → 16/4) lengths, with and without the causal and padding bias:
    the port's ring against JAX's ``ring_attention`` on a 2 x 4 mesh and
    against ``_xla_attention_bshd``."""
    q, k, v, w, bias, scale = _inputs(S, with_bias, S + with_bias)
    mesh = _sp_mesh(eight_devices)
    jb = None if bias is None else jnp.asarray(bias)

    def jax_loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) * jnp.asarray(w))
    ring = jax.jit(lambda q, k, v: jax_ring_attention(q, k, v, jb, scale,
                                                      mesh))
    xla = (lambda q, k, v: _xla_attention_bshd(q, k, v, jb, scale))
    jargs = tuple(jnp.asarray(x) for x in (q, k, v))
    want = {"ring": (np.asarray(ring(*jargs)),
                     jax.jit(jax.grad(jax_loss(ring), (0, 1, 2)))(*jargs)),
            "xla": (np.asarray(xla(*jargs)),
                    jax.grad(jax_loss(xla), (0, 1, 2))(*jargs))}
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ring_one_process(tq, tk, tv, None if bias is None
                           else torch.from_numpy(bias), scale)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    for name, (out, jgrads) in want.items():
        np.testing.assert_allclose(got.detach().numpy(), out, **FWD,
                                   err_msg=name)
        for g, jg, what in zip(grads, jgrads, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD,
                                       err_msg=f"{name} d{what}")


@pytest.mark.parametrize("S", [13, 16])
def test_ring_fully_masked_row_follows_jax_s_ring(S, eight_devices):
    """A query row whose every key is masked (−1e9) comes out as JAX's
    ring gives it: its real keys and the pad keys (zeros, at −1e9 too)
    weigh alike, so at S = 13 (padded to 16) it is Σv / 16, at S = 16
    the mean of v, as ``_xla_attention_bshd`` gives it. (GSPMD SP cuts
    the gathered keys to S: the mean, as XLA's.)"""
    q, k, v, _, _, scale = _inputs(S, False, 5)
    bias = np.zeros((2, 1, S, S), np.float32)
    bias[0, :, 4, :] = -1e9
    jargs = tuple(jnp.asarray(x) for x in (q, k, v))
    want = np.asarray(jax.jit(lambda q, k, v: jax_ring_attention(
        q, k, v, jnp.asarray(bias), scale, _sp_mesh(eight_devices)))(*jargs))
    got = ring_one_process(*(torch.from_numpy(x) for x in (q, k, v, bias)),
                           scale).numpy()
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(got[0, 4], v[0].sum(0) / 16, **FWD)
    if S == 16:
        np.testing.assert_allclose(got, np.asarray(_xla_attention_bshd(
            *jargs, jnp.asarray(bias), scale)), **FWD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gathered_attention_matches_xla_at_unequal_lengths(dtype,
                                                           monkeypatch):
    """GSPMD SP's attention on a rank: its 5 query rows against all 13
    keys (Sq ≠ Sk) with the bias of its rows, against
    ``_xla_attention_bshd`` with fp32 scores
    (``CFA_ATTENTION_PROBS_FP32=1``): forward and gradients, fp32 at JAX's
    tolerances; bf16 within one bf16 step (2^-7) of the output's and the
    gradients' largest entry."""
    monkeypatch.setenv("CFA_ATTENTION_PROBS_FP32", "1")
    q, k, v, w, bias, scale = _inputs(13, True, 3)
    q, bias = q[:, 5:10], bias[:, :, 5:10]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_loss(q, k, v):
        o = _xla_attention_bshd(q, k, v, jnp.asarray(bias), scale)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w[:, :5]))
    jargs = tuple(jnp.asarray(x, jdt) for x in (q, k, v))
    want = np.asarray(_xla_attention_bshd(*jargs, jnp.asarray(bias), scale)
                      .astype(jnp.float32))
    jgrads = jax.grad(jax_loss, (0, 1, 2))(*jargs)
    targs = tuple(torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    got = sq.xla_attention(*targs, torch.from_numpy(bias), scale)
    grads = torch.autograd.grad(
        (got.float() * torch.from_numpy(w[:, :5])).sum(), targs)
    fwd, grad = (FWD, GRAD) if dtype == "float32" else (
        dict(rtol=0, atol=2 ** -7 * np.abs(want).max()), None)
    np.testing.assert_allclose(got.detach().float().numpy(), want, **fwd)
    for g, jg in zip(grads, jgrads):
        jg = np.asarray(jg.astype(jnp.float32))
        tol = grad or dict(rtol=0, atol=2 ** -7 * np.abs(jg).max())
        np.testing.assert_allclose(g.float().numpy(), jg, **tol)


def test_constrain_and_gather_blocks_pad_and_drop():
    """Rank i's block is tokens [i·Sp/n, (i+1)·Sp/n) of the sequence
    zero-padded to Sp; the ring's bias of its rows puts the pad keys at
    −1e9, GSPMD's keeps the S real keys only; ranks' blocks put together
    and cut to S are the sequence again."""
    x = torch.arange(2 * 13 * 3, dtype=torch.float32).reshape(2, 13, 3)
    blocks = [sq.constrain_tokens(x, _spec(i)) for i in range(N)]
    assert all(b.shape == (2, 4, 3) for b in blocks)
    assert torch.equal(torch.cat(blocks, 1)[:, :13], x)
    assert not blocks[-1][:, 1:].any()
    bias = torch.zeros((1, 1, 13, 13))
    ring = sq.local_bias(bias, 13, _spec(3))
    assert ring.shape == (1, 1, 4, 16)
    assert (ring[..., 13:] == -1e9).all() and not ring[..., :13].any()
    assert sq.local_bias(None, 13, _spec(3)).shape == (1, 1, 4, 16)
    assert sq.local_bias(None, 16, _spec(3)) is None
    gspmd = sq.local_bias(bias, 13, _spec(1, ring=False))
    assert gspmd.shape == (1, 1, 4, 13)
    assert sq.local_bias(None, 13, _spec(1, ring=False)) is None


# The configurations JAX's make_train_step refuses, with its words.
SP_REFUSALS = [
    (dict(sequence_parallel=True, global_negatives=True),
     dict(data=8, model=1), "mesh.model > 1"),
    (dict(sequence_parallel=True), dict(data=2, model=4),
     "sequence parallelism requires global_negatives=True"),
    (dict(sequence_parallel=True, global_negatives=True),
     dict(data=2, model=2, pipe=2),
     "sequence parallelism composed with pipeline parallelism"),
]


@pytest.mark.parametrize("kw,mesh_kw,message", SP_REFUSALS)
def test_sp_refusals_are_jax_s(kw, mesh_kw, message, eight_devices):
    cfg = W.train_config(mesh=MeshConfig(**mesh_kw), **kw)
    with pytest.raises(ValueError, match=message):
        engine.check_parallel(cfg)
    with pytest.raises(ValueError, match=message):
        engine.Trainer(cfg, W.initial_state(0), device="cpu")
    jcfg = JaxTrainConfig(clip_model="tiny", mesh=JaxMeshConfig(**mesh_kw),
                          **kw)
    params = jm.init_clip_params(jax.random.key(0),
                                 JaxCLIPConfig.tiny_test())
    with pytest.raises(ValueError, match=message):
        jax_make_train_step(jcfg, jcfg.model_config(),
                            jax_make_optimizer(jcfg, params),
                            mesh=jmesh.make_mesh(jcfg.mesh, eight_devices))


def test_sp_on_one_process_is_the_ordinary_step():
    """As in JAX, ``sequence_parallel`` (and ``sp_ring``) on a one-rank
    mesh change nothing: the step is the ordinary one, bit for bit."""
    from test_torch_parallel import assert_same_state, one_process_step
    kw = dict(loss_type="sparc", optimizer_type="adamspd")
    got = one_process_step(dict(kw, sequence_parallel=True, sp_ring=True),
                           3, 4)
    want = one_process_step(kw, 3, 4)
    assert got[0] == want[0]
    assert_same_state(got[1], want[1])


@pytest.mark.parametrize("model", ["tiny", "ViT-B/16"])
def test_sp_data_dims_match_jax_megatron_base_false(model, eight_devices):
    """Under SP the data rule is JAX's ``megatron_base=False`` one: on a
    2 x 2 (data x model) mesh, leaf by leaf, the dim the port splits over
    ``data`` is the one JAX's ``fsdp_param_specs`` and ``zero1_opt_specs``
    pick, and no leaf is split over ``model``. The port's layout on such a
    mesh splits no parameter over ``model`` and counts a tensor's sums on
    model rank 0 alone."""
    from clip_finegrained_alignment_tpu.parallel import sharding_rules as jsr
    from clip_finegrained_alignment_tpu_torch.models import clip as tm
    from clip_finegrained_alignment_tpu_torch.parallel import sharding_rules
    from clip_finegrained_alignment_tpu_torch.parallel.zero import \
        ShardLayout
    cfg = JaxCLIPConfig.from_name(model)
    params = jax.eval_shape(lambda: jm.init_clip_params(jax.random.key(0),
                                                        cfg))
    opt_state = jax.eval_shape(jax_make_optimizer(JaxTrainConfig(
        clip_model=model, optimizer_type="adamspd"), params).init, params)
    mesh = jmesh.make_mesh(JaxMeshConfig(data=2, model=2), eight_devices[:4])
    is_spec = (lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for tree, specs, port_specs in (
            (params, jsr.fsdp_param_specs(params, mesh, megatron_base=False),
             sharding_rules.fsdp_param_specs),
            (opt_state, jsr.zero1_opt_specs(opt_state, mesh,
                                            megatron_base=False),
             sharding_rules.zero1_opt_specs)):
        shapes = {jax.tree_util.keystr(p): getattr(x, "shape", ())
                  for p, x in jax.tree_util.tree_leaves_with_path(tree)}
        leaves = jax.tree_util.tree_leaves_with_path(specs, is_leaf=is_spec)
        assert all("model" not in tuple(s) for _, s in leaves)
        want = {jax.tree_util.keystr(p): next(
            (i for i, a in enumerate(s) if a == jmesh.DATA_AXIS), None)
            for p, s in leaves}
        assert port_specs(shapes, 2) == want
    with torch.device("meta"):
        whole = tm.CLIPModel(CLIPConfig.from_name(model))
    named = list(whole.named_parameters())
    for model_rank in (0, 1):
        layout = ShardLayout(named, Mesh(
            data=2, rank=model_rank, device=torch.device("cpu"), model=2,
            sequence_parallel=True), fsdp=False)
        assert layout.tp_dims == [None] * len(named)
        assert not layout.model_parallel
        assert layout.dims == [sharding_rules.data_shard_dim(
            tuple(p.shape), 2) for _, p in named]
        assert [layout.counts(i, False) for i in range(len(named))] == \
            [model_rank == 0] * len(named)
