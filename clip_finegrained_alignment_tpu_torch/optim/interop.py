"""The reference's optimizer state in both directions, AdamSPD and AdamW:
the port of ``clip_finegrained_alignment_tpu/optim/interop.py``.

The reference's training checkpoints carry a torch ``optimizer_state_dict``
whose per-parameter entries (``step``, ``exp_avg``, ``exp_avg_sq``,
``max_exp_avg_sq`` under amsgrad) are keyed by parameter POSITION, and its
AdamSPD keeps the anchors in ``param_groups[0]['pre']``, a list by
position. A weights-only import resets the moments and re-anchors SPD at
the mid-run weights; these functions carry the whole state across.

Position → name: the reference builds its groups from HF ``CLIPModel``'s
``named_parameters()`` order (:func:`hf_named_parameter_order`; text
tower first, attention k, v, q, out). The port registers the vision tower
first and q, k, v, out (:func:`port_parameter_order`). Both carry HF
names and HF shapes, so the mapping is a reorder by name, with no
reshaping.

The port's side is a ``ClippedOptimizer.state_dict()`` (what a checkpoint
directory's ``state.pt`` holds under ``"optimizer"``): the inner torch
optimizer's state dict and the update ``count``.

* AdamSPD (``optim/adamspd.py``): one group over the port's parameters;
  each parameter's state holds its ``anchor``, and after the first update
  ``step`` (an int), the moments and, under amsgrad, the maxima.
* AdamW (``torch.optim.AdamW`` on ``optim/factory.py``'s two groups,
  decay first): the reference numbers positions across its two groups,
  decay group first, each in HF order; ``step`` is a 0-d float tensor.

An import keeps the live optimizer's hyperparameters (its param groups);
the CLI warns where the checkpoint's differ. Step counts line up: torch
and the port increment ``step`` before the bias corrections, so after k
updates both hold k.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

from ..config import CLIPConfig
from .factory import decay_mask

# The torch.optim.AdamW group fields the reference's state dicts carry.
_ADAMW_GROUP = dict(amsgrad=False, maximize=False, foreach=None,
                    capturable=False, differentiable=False, fused=None,
                    decoupled_weight_decay=True)


def hf_named_parameter_order(cfg: CLIPConfig) -> List[str]:
    """``transformers.CLIPModel(cfg).named_parameters()`` order, the
    module-registration order of HF's modeling_clip.py: logit_scale, the
    text tower, the vision tower, the projections; attention registers k,
    v, q, out; the encoder layer attn, ln1, mlp, ln2."""
    def lin(p):
        return [f"{p}.weight", f"{p}.bias"]

    def block(p):
        names = []
        for mod in ("self_attn.k_proj", "self_attn.v_proj",
                    "self_attn.q_proj", "self_attn.out_proj"):
            names += lin(f"{p}.{mod}")
        names += lin(f"{p}.layer_norm1")
        names += lin(f"{p}.mlp.fc1") + lin(f"{p}.mlp.fc2")
        names += lin(f"{p}.layer_norm2")
        return names

    order = ["logit_scale",
             "text_model.embeddings.token_embedding.weight",
             "text_model.embeddings.position_embedding.weight"]
    for i in range(cfg.text.num_layers):
        order += block(f"text_model.encoder.layers.{i}")
    order += lin("text_model.final_layer_norm")
    order += ["vision_model.embeddings.class_embedding",
              "vision_model.embeddings.patch_embedding.weight",
              "vision_model.embeddings.position_embedding.weight"]
    order += lin("vision_model.pre_layrnorm")  # sic: HF's attribute name
    for i in range(cfg.vision.num_layers):
        order += block(f"vision_model.encoder.layers.{i}")
    order += lin("vision_model.post_layernorm")
    order += ["visual_projection.weight", "text_projection.weight"]
    return order


def _shapes(cfg: CLIPConfig) -> Dict[str, Tuple[int, ...]]:
    """The port's parameter shapes by name, in registration order (the
    model built on the meta device)."""
    from ..models.clip import CLIPModel
    with torch.device("meta"):
        return {n: tuple(p.shape)
                for n, p in CLIPModel(cfg).named_parameters()}


def port_parameter_order(cfg: CLIPConfig) -> List[str]:
    """``models/clip.py::CLIPModel(cfg).named_parameters()`` order, the
    order of the port's AdamSPD group."""
    return list(_shapes(cfg))


def adamw_group_orders(cfg: CLIPConfig) -> Tuple[List[str], List[str]]:
    """The reference AdamW's two groups in HF order: (decay, no decay) by
    its name filter ``"ln" in n or "bn" in n or "bias" in n``, of which only
    ``bias`` matches an HF CLIP name."""
    no_decay = lambda n: "ln" in n or "bn" in n or "bias" in n
    order = hf_named_parameter_order(cfg)
    return ([n for n in order if not no_decay(n)],
            [n for n in order if no_decay(n)])


def _port_adamw_groups(cfg: CLIPConfig) -> List[List[str]]:
    """The port's AdamW groups in port order (``factory.make_optimizer``)."""
    order = port_parameter_order(cfg)
    mask = decay_mask(order)
    groups = [[n for n in order if mask[n]], [n for n in order if not mask[n]]]
    return [g for g in groups if g]


def _scalar(x) -> int:
    """A step count held as an int or a 0-d tensor."""
    return int(x.item() if hasattr(x, "item") else x)


def _cpu(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32).clone()


def _positions(groups: Sequence[Mapping[str, Any]],
               names: Sequence[Sequence[str]]) -> Dict[int, str]:
    """State index → parameter name, group by group."""
    if [len(g["params"]) for g in groups] != [len(n) for n in names]:
        raise ValueError(
            f"group sizes {[len(g['params']) for g in groups]} do not match "
            f"{[len(n) for n in names]} for this model config (wrong "
            "--model family?)")
    return {int(i): n for g, ns in zip(groups, names)
            for i, n in zip(g["params"], ns)}


def _by_name(opt_sd: Mapping[str, Any], pos: Mapping[int, str],
             keys: Sequence[str]) -> Tuple[int, Dict[str, Dict[str, Any]]]:
    """(the common step, {name: {key: tensor}}) of a reference state."""
    state = {int(k): v for k, v in opt_sd["state"].items()}
    missing = [i for i in pos if i not in state]
    if missing:
        raise ValueError(f"{len(missing)} params have no optimizer state "
                         f"(e.g. index {missing[0]}): saved before any step?")
    steps = {_scalar(state[i]["step"]) for i in pos}
    if len(steps) != 1:
        raise ValueError(f"non-uniform per-param step counts {sorted(steps)}")
    return steps.pop(), {n: {k: state[i][k] for k in keys}
                         for i, n in pos.items()}


def _port_state(state: Mapping[str, Any], names
                ) -> Tuple[int, Dict[str, Dict[str, Any]]]:
    """(update count, {name: per-parameter state}) of a port
    ``ClippedOptimizer.state_dict()`` whose groups hold ``names``."""
    inner = state["optimizer"]
    pos = _positions(inner["param_groups"], names)
    entries = {int(k): v for k, v in inner["state"].items()}
    return int(state["count"]), {n: entries.get(i, {})
                                 for i, n in pos.items()}


# ---------------------------------------------------------------------------
# AdamSPD
# ---------------------------------------------------------------------------

def is_adamspd_state(state: Mapping[str, Any]) -> bool:
    """Whether a port ``ClippedOptimizer.state_dict()`` is AdamSPD's (its
    parameters carry anchors)."""
    return any("anchor" in s for s in state["optimizer"]["state"].values())


def reference_optimizer_state_dict(state: Mapping[str, Any],
                                   cfg: CLIPConfig, *, lr: float, betas,
                                   eps: float, weight_decay: float,
                                   amsgrad: bool = False) -> Dict[str, Any]:
    """The port's AdamSPD state (a ``ClippedOptimizer.state_dict()``) → a
    reference torch ``AdamSPD.state_dict()``: states and ``pre`` anchors by
    HF position, the hyperparameters in the one group. Before the first
    update the step is 0 and the moments zeros."""
    if not is_adamspd_state(state):
        raise ValueError("no AdamSPD state (no anchors): the optimizer is "
                         "not adamspd")
    count, per = _port_state(state, [port_parameter_order(cfg)])
    order = hf_named_parameter_order(cfg)
    packed: Dict[int, Dict[str, Any]] = {}
    for i, name in enumerate(order):
        st = per[name]
        zeros = torch.zeros_like(_cpu(st["anchor"]))
        entry = {"step": _scalar(st.get("step", 0)),
                 "exp_avg": _cpu(st["exp_avg"]) if "exp_avg" in st
                 else zeros.clone(),
                 "exp_avg_sq": _cpu(st["exp_avg_sq"]) if "exp_avg_sq" in st
                 else zeros.clone()}
        if amsgrad:
            entry["max_exp_avg_sq"] = _cpu(st["max_exp_avg_sq"]) \
                if "max_exp_avg_sq" in st else zeros.clone()
        packed[i] = entry
    steps = {e["step"] for e in packed.values()}
    if steps != {count}:
        raise ValueError(f"per-parameter steps {sorted(steps)} differ from "
                         f"the update count {count}")
    group = {"lr": float(lr), "betas": tuple(betas), "eps": float(eps),
             "weight_decay": float(weight_decay), "amsgrad": bool(amsgrad),
             "pre": [_cpu(per[name]["anchor"]) for name in order],
             "params": list(range(len(order)))}
    return {"state": packed, "param_groups": [group]}


def adamspd_state_from_reference(opt_sd: Mapping[str, Any], cfg: CLIPConfig,
                                 param_groups: Sequence[Mapping[str, Any]]
                                 ) -> Dict[str, Any]:
    """A reference ``AdamSPD.state_dict()`` → the port's
    ``ClippedOptimizer.state_dict()`` with ``param_groups`` (the live
    optimizer's, whose hyperparameters are kept). ``pre=None`` (the
    reference then decays toward zeros) gives zero anchors."""
    groups = opt_sd["param_groups"]
    if len(groups) != 1 or "pre" not in groups[0]:
        raise ValueError(
            "optimizer_state_dict is not reference AdamSPD state (expected "
            "one param group carrying 'pre' anchors); got "
            f"{len(groups)} group(s) with keys {[sorted(g) for g in groups]}")
    g = groups[0]
    amsgrad = bool(g.get("amsgrad", False))
    if amsgrad != bool(param_groups[0]["amsgrad"]):
        raise ValueError(f"checkpoint amsgrad={amsgrad}, this optimizer "
                         f"amsgrad={param_groups[0]['amsgrad']}")
    order = hf_named_parameter_order(cfg)
    pos = _positions(groups, [order])
    keys = ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if amsgrad
                                        else ())
    step, per = _by_name(opt_sd, pos, keys)
    pre = g["pre"]
    anchors = {n: (_cpu(pre[j]) if pre is not None
                   else torch.zeros_like(_cpu(per[n]["exp_avg"])))
               for j, n in enumerate(pos[int(i)] for i in g["params"])}
    port = port_parameter_order(cfg)
    _positions(param_groups, [port])
    state = {}
    for i, name in enumerate(port):
        entry = {"anchor": anchors[name], "step": step}
        entry.update({k: _cpu(v) for k, v in per[name].items()})
        state[i] = entry
    return {"optimizer": {"state": state,
                          "param_groups": [dict(x) for x in param_groups]},
            "count": step}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def reference_adamw_optimizer_state_dict(state: Mapping[str, Any],
                                         cfg: CLIPConfig, *, lr: float,
                                         betas, eps: float,
                                         weight_decay: float
                                         ) -> Dict[str, Any]:
    """The port's AdamW state (a ``ClippedOptimizer.state_dict()``) → a
    reference torch ``AdamW.state_dict()`` with its two-group decay split,
    positions decay group first."""
    if is_adamspd_state(state):
        raise ValueError("AdamSPD state: use reference_optimizer_state_dict")
    count, per = _port_state(state, _port_adamw_groups(cfg))
    decay, no_decay = adamw_group_orders(cfg)
    shapes = _shapes(cfg)
    packed: Dict[int, Dict[str, Any]] = {}
    for i, name in enumerate(decay + no_decay):
        st = per[name] or {    # before the first update
            "step": torch.tensor(float(count)),
            "exp_avg": torch.zeros(shapes[name]),
            "exp_avg_sq": torch.zeros(shapes[name])}
        if _scalar(st["step"]) != count:
            raise ValueError(f"{name}: step {_scalar(st['step'])} differs "
                             f"from the update count {count}")
        packed[i] = {"step": st["step"].detach().to("cpu").clone(),
                     "exp_avg": _cpu(st["exp_avg"]),
                     "exp_avg_sq": _cpu(st["exp_avg_sq"])}
    base = dict(lr=float(lr), betas=tuple(betas), eps=float(eps),
                **_ADAMW_GROUP)
    g0 = dict(base, weight_decay=float(weight_decay),
              params=list(range(len(decay))))
    g1 = dict(base, weight_decay=0.0,
              params=list(range(len(decay), len(decay) + len(no_decay))))
    return {"state": packed, "param_groups": [g0, g1]}


def adamw_state_from_reference(opt_sd: Mapping[str, Any], cfg: CLIPConfig,
                               param_groups: Sequence[Mapping[str, Any]]
                               ) -> Dict[str, Any]:
    """A reference ``AdamW.state_dict()`` (the two-group decay split, or
    one group over ``model.parameters()`` in registration order) → the
    port's ``ClippedOptimizer.state_dict()`` with ``param_groups`` (the
    live optimizer's, in the port's group order, hyperparameters kept)."""
    groups = opt_sd["param_groups"]
    if any("pre" in g for g in groups):
        raise ValueError("checkpoint carries AdamSPD state: use "
                         "adamspd_state_from_reference")
    if any(g.get("amsgrad") for g in groups):
        raise ValueError("amsgrad AdamW state has no counterpart in the "
                         "port's AdamW (its maxima would be dropped)")
    expect = list(adamw_group_orders(cfg)) if len(groups) == 2 \
        else [hf_named_parameter_order(cfg)]
    step, per = _by_name(opt_sd, _positions(groups, expect),
                         ("exp_avg", "exp_avg_sq"))
    port = _port_adamw_groups(cfg)
    _positions(param_groups, port)
    state = {}
    for i, name in enumerate(n for g in port for n in g):
        state[i] = {"step": torch.tensor(float(step)),
                    **{k: _cpu(v) for k, v in per[name].items()}}
    return {"optimizer": {"state": state,
                          "param_groups": [dict(x) for x in param_groups]},
            "count": step}


# ---------------------------------------------------------------------------
# Into a live optimizer
# ---------------------------------------------------------------------------

def load_reference_state(optimizer, opt_sd: Mapping[str, Any],
                         cfg: CLIPConfig) -> int:
    """Restore a reference ``optimizer_state_dict`` into a live
    ``optim/factory.py::ClippedOptimizer`` (AdamSPD or AdamW, whichever it
    wraps), keeping its hyperparameters; returns the imported step."""
    from .adamspd import AdamSPD
    groups = optimizer.state_dict()["optimizer"]["param_groups"]
    convert = adamspd_state_from_reference \
        if isinstance(optimizer.optimizer, AdamSPD) \
        else adamw_state_from_reference
    state = convert(opt_sd, cfg, groups)
    optimizer.load_state_dict(state)
    return state["count"]
