"""Which dim of each parameter is split over which mesh axis: the port of
``clip_finegrained_alignment_tpu/parallel/sharding_rules.py`` (the
Megatron rules ``_LAYER_RULES``, the composed base layout ``_base_spec``,
the data-axis choice ``_data_axis_specs`` of ZeRO-1 and FSDP, and
``validate_tp_divisibility``).

JAX returns ``PartitionSpec`` trees over stacked ``[L, in, out]`` kernels;
the port keeps one tensor a layer with torch's ``[out, in]`` weights, so
here the rules are pure functions of an HF parameter name and a shape:

* **model** (tensor parallelism, :func:`tp_dim`), only inside
  ``encoder.layers``: column-parallel ``q_proj``, ``k_proj``, ``v_proj``
  and ``fc1`` split dim 0 of their weight and bias; row-parallel
  ``out_proj`` and ``fc2`` split dim 1 of their weight, and their bias
  stays whole (it is added once, after the all-reduce). Everything else
  is whole: embeddings, LayerNorms, projections, ``logit_scale``.
* **pipe** (pipeline parallelism): encoder layer ``i`` of a tower lives
  on stage ``i // (L / K)`` (``models/clip.py::Encoder``); everything else
  is whole on every stage. JAX shards the stacked L dim, which has no
  counterpart in a per-layer tensor: the stage is the layer's index, not
  a dim.
* **data** (ZeRO-1, FSDP, :func:`data_shard_dim`): the largest dim the
  model axis left unclaimed and the data-rank count divides, the first of
  equal ones; with no such dim (a scalar, a dim smaller than the count,
  a row-parallel bias whose only dim TP took) the tensor stays whole over
  the data ranks. With one data rank nothing is split. JAX's choice over
  ``[L, in, out]`` is the same one mapped through the transposition,
  except where JAX picks L itself, which a per-layer tensor cannot take
  (``tests/test_torch_model_parallel.py`` holds them leaf by leaf).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

Shape = Sequence[int]

# (module, parameter) inside an encoder layer → the dim TP splits.
_LAYER_RULES = {
    ("q_proj", "weight"): 0, ("q_proj", "bias"): 0,
    ("k_proj", "weight"): 0, ("k_proj", "bias"): 0,
    ("v_proj", "weight"): 0, ("v_proj", "bias"): 0,
    ("out_proj", "weight"): 1,
    ("fc1", "weight"): 0, ("fc1", "bias"): 0,
    ("fc2", "weight"): 1,
}
_LAYERS = ".encoder.layers."


def tp_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` (HF naming) split over the ``model``
    ranks, or None when it is whole on every one."""
    if _LAYERS not in name:
        return None
    parts = name.rsplit(".", 2)
    return _LAYER_RULES.get((parts[-2], parts[-1]))


def layer_index(name: str) -> Optional[int]:
    """The encoder-layer index of parameter ``name``, or None outside the
    encoder layers."""
    if _LAYERS not in name:
        return None
    return int(name.split(_LAYERS, 1)[1].split(".", 1)[0])


def before_pipeline(name: str) -> bool:
    """Whether parameter ``name`` is used before the encoder layers (the
    embeddings and the vision tower's pre-LayerNorm): under a pipeline
    only stage 0 computes them, so their gradient lives there alone."""
    return ".embeddings." in name or name.startswith(
        "vision_model.pre_layrnorm.")


def before_gather(name: str) -> bool:
    """Whether parameter ``name`` is used before a tower's output is
    gathered under sequence parallelism (the embeddings, the vision
    pre-LayerNorm, the encoder layers): its gradient on a model rank is
    that rank's tokens' part (``parallel/sequence.py``, the gradient
    rule)."""
    return before_pipeline(name) or layer_index(name) is not None


def data_shard_dim(shape: Shape, dp: int,
                   taken: Optional[int] = None) -> Optional[int]:
    """The dim of ``shape`` split over ``dp`` data ranks, or None.
    ``taken``: the dim the model axis claimed first (never chosen)."""
    if dp == 1 or not shape:
        return None
    best = None
    for i, s in enumerate(shape):
        if i != taken and s % dp == 0 and s >= dp and (
                best is None or s > shape[best]):
            best = i
    return best


def zero1_opt_specs(shapes: Mapping[str, Shape], dp: int
                    ) -> Dict[str, Optional[int]]:
    """Name → split dim of each optimizer-state tensor (ZeRO-1: each rank
    keeps and updates 1/dp of the moments and anchors), as a pure
    function of the shape, with no model axis."""
    return {name: data_shard_dim(tuple(shape), dp)
            for name, shape in shapes.items()}


def fsdp_param_specs(shapes: Mapping[str, Shape], dp: int
                     ) -> Dict[str, Optional[int]]:
    """Name → split dim of each parameter (FSDP: each rank keeps 1/dp of
    every parameter between steps, and its optimizer state with it). The
    same rule as :func:`zero1_opt_specs`, as in JAX."""
    return zero1_opt_specs(shapes, dp)


def validate_tp_divisibility(shapes: Mapping[str, Shape], tp: int,
                             heads: Optional[Mapping[str, int]] = None
                             ) -> None:
    """Raise before anything is built when a dim the model axis splits
    does not divide by ``tp`` (name → whole shape), or, with ``heads``
    (tower prefix → head count), when a tower's heads do not: a rank runs
    whole heads."""
    if tp == 1:
        return
    problems = []
    for name, shape in shapes.items():
        d = tp_dim(name)
        if d is not None and shape[d] % tp:
            problems.append(f"{name}: dim {d} size {shape[d]} not "
                            f"divisible by model={tp}")
    for tower, h in (heads or {}).items():
        if h % tp:
            problems.append(f"{tower}: {h} heads not divisible by "
                            f"model={tp}")
    if problems:
        raise ValueError("tensor-parallel divisibility failures:\n  "
                         + "\n  ".join(problems[:10]))
