"""The benchmark's frozen arithmetic: the model FLOPs against the port's
``utils/flops.py``, each kernel role's bound against the kernel table's
bounds (PERF.md, §6), and the weights' names and shapes against the port's
model."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import flops, spec, weights
from port_bench.kernels.counts import bound_seconds, work

CONFIGS = {"clip-vit-b16": "ViT-B/16", "clip-vit-l14-336": "ViT-L/14@336"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flops_equal_the_ports(name):
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.utils import flops as port
    cfg, pcfg = spec.load("configs", name), CLIPConfig.from_name(
        CONFIGS[name])
    assert flops.image_forward_flops(cfg) == port.image_forward_flops(pcfg)
    assert flops.text_forward_flops(cfg) == port.text_forward_flops(pcfg)
    for pairs in (1, 256):
        assert flops.sparc_step_flops(cfg, pairs) == \
            port.sparc_train_step_flops(pcfg, pairs)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_is_the_ports(name):
    """The configuration file runs the port at its named model's widths."""
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from port_bench.drivers.train import port_config
    cfg = spec.load("configs", name)
    assert port_config(cfg) == CLIPConfig.from_name(CONFIGS[name])
    assert cfg["reduced"] == []


# (role, call, bound ms, what bounds it): the kernel table's shapes. #1 at
# B=64 ViT-B/16 vision in serving (no lse) and ViT-L/14@336 [32, 577, 16,
# 64]; #2 at the B=32 train microbatch (the table's 7 tensors, 0.02023 ms,
# plus the lse pair it reads: 0.9 % more) and at [32, 577, 16, 64];
# #3 / #4 at B=32 T=77 P=197 E=512 and at P=577 E=768.
B16 = {"B": 64, "S": 197, "H": 12, "D": 64, "dt": "bf16"}
L336 = {"B": 32, "S": 577, "H": 16, "D": 64, "dt": "bf16"}
TABLE = [
    ("attention_fwd", B16, 0.02312, "bytes", 5e-4),
    ("attention_fwd", L336, 0.0452, "bytes", 2e-3),
    ("attention_bwd", dict(B16, B=32, lse=True), 0.02023, "bytes", 1e-2),
    ("attention_bwd", dict(L336, lse=True), 0.1103, "operations", 5e-4),
    ("sparc_fwd", {"B": 32, "T": 77, "P": 197, "E": 512}, 0.00746, "bytes",
     1e-3),
    ("sparc_bwd", {"B": 32, "T": 77, "P": 197, "E": 512}, 0.01282, "bytes",
     1e-3),
    ("sparc_fwd", {"B": 32, "T": 77, "P": 577, "E": 768}, 0.0265,
     "operations", 2e-3),
]


@pytest.mark.parametrize("role,call,ms,by,rtol", TABLE)
def test_bounds_match_the_kernel_table(role, call, ms, by, rtol):
    seconds, what = bound_seconds(role, call)
    assert what == by
    assert seconds * 1e3 == pytest.approx(ms, rel=rtol)


def test_counts_from_shapes():
    ops, nbytes, prec = work("attention_fwd", dict(B16, lse=True, bias=77))
    assert ops == 4 * 64 * 12 * 197 ** 2 * 64
    assert nbytes == 4 * 64 * 197 * 12 * 64 * 2 + 2 * 64 * 12 * 197 * 4 \
        + 77 * 4
    assert prec == "bf16"
    ops, _, prec = work("sparc_bwd", {"B": 2, "T": 3, "P": 5, "E": 7})
    assert (ops, prec) == (8 * 2 * 3 * 5 * 7, "fp32")
    with pytest.raises(KeyError):
        work("flash_fwd", {})


def test_kernel_files():
    impls = spec.kernel_impls()
    assert set(impls) == {"attention_fwd", "attention_bwd", "sparc_fwd",
                          "sparc_bwd"}
    names = {"attention_fwd": "void (anonymous namespace)::attention_fwd_mma"
             "<64>(bf16 const*)",
             "attention_bwd": "attention_bwd_dkdv_mma<64>",
             "sparc_fwd": "sparc_fwd_kernel(float const*)",
             "sparc_bwd": "sparc_bwd_cols_kernel"}
    for role, name in names.items():
        assert any(i["match"].search(name) for i in impls[role])


@pytest.mark.parametrize("name", ["tiny", *sorted(CONFIGS)])
def test_weights_are_the_ports_parameters(name):
    """Every parameter of the port's model, by HF name and shape, and no
    other; the same seed gives the same weights."""
    from clip_finegrained_alignment_tpu_torch.models.clip import CLIPModel
    from port_bench.drivers.train import port_config
    cfg = spec.load("configs", name) if name != "tiny" else json.loads(
        (Path(__file__).parent / "data/configs/tiny.json").read_text())
    with torch.device("meta"):
        model = CLIPModel(port_config(cfg))
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(s) for n, s, _, _ in weights.shapes(cfg)} == want
    if name == "tiny":
        dev = torch.device("cpu")
        a = weights.state_dict(cfg, weights.generator(2**31 + 5, dev), dev)
        b = weights.state_dict(cfg, weights.generator(2**31 + 5, dev), dev)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert float(a["logit_scale"]) == pytest.approx(2.6592)
