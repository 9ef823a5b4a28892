"""The data-axis layout of ZeRO-1 and FSDP: the port of the data-axis half
of ``clip_finegrained_alignment_tpu/parallel/sharding_rules.py``
(``_data_axis_specs``, ``zero1_opt_specs``, ``fsdp_param_specs``).

Per tensor, the dim that is split over the ``data`` ranks is the largest
one divisible by their count, the first of equal ones; a tensor with no
such dim (a scalar, a dim smaller than the count) stays whole on every
rank. With one rank nothing is split. JAX returns ``PartitionSpec`` trees;
here the rule is a pure function of a shape, and the specs map names to
the dim (or None).

The Megatron rules (``_LAYER_RULES``, ``validate_tp_divisibility``) that
claim dims for the ``model`` axis first are ROADMAP A6b.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

Shape = Sequence[int]


def data_shard_dim(shape: Shape, dp: int) -> Optional[int]:
    """The dim of ``shape`` split over ``dp`` data ranks, or None."""
    if dp == 1 or not shape:
        return None
    best = None
    for i, s in enumerate(shape):
        if s % dp == 0 and s >= dp and (best is None or s > shape[best]):
            best = i
    return best


def zero1_opt_specs(shapes: Mapping[str, Shape], dp: int
                    ) -> Dict[str, Optional[int]]:
    """Name → split dim of each optimizer-state tensor (ZeRO-1: each rank
    keeps and updates 1/dp of the moments and anchors)."""
    return {name: data_shard_dim(tuple(shape), dp)
            for name, shape in shapes.items()}


def fsdp_param_specs(shapes: Mapping[str, Shape], dp: int
                     ) -> Dict[str, Optional[int]]:
    """Name → split dim of each parameter (FSDP: each rank keeps 1/dp of
    every parameter between steps, and its optimizer state with it). The
    same rule as :func:`zero1_opt_specs`, as in JAX."""
    return zero1_opt_specs(shapes, dp)
