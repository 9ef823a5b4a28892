"""Each kernel role's work from its call's shapes alone, so that a roofline
reads the same work whatever implements the role.

A call is a dict of shapes; :func:`work` returns (operations, bytes,
precision). Each input byte is counted read once and each output byte
written once; the products are those the inputs need (an additive bias
needs every score, so all S² are counted).

* ``attention_fwd``: q, k, v [B, S, H, D] read, o written (dtype ``dt``),
  the bias (fp32, ``bias`` elements) read, and with ``lse`` the fp32 pair
  [2, B, H, S] written; QKᵀ and PV: 4·B·H·S²·D.
* ``attention_bwd``: q, k, v, do read, dq, dk, dv written, the lse pair and
  the bias read; five products: 10·B·H·S²·D.
* ``sparc_fwd`` (fp32): v [B, P, E] and l [B, T, E] and the mask [B, T] read,
  out [B, T, E], sim [B, T, P], rl [B, T], rv [B, P] written (the backward's
  residuals); sim = l·vᵀ and out = w·v: 4·B·T·P·E.
* ``sparc_bwd`` (fp32): v, l, mask, g [B, T, E], sim, rl, rv read, dv, dl
  written; twice the forward's products: 8·B·T·P·E.
"""

from __future__ import annotations

from typing import Tuple

from ..flops import HBM_BYTES_PER_S, PEAK_FLOPS

DTYPE_BYTES = {"bf16": 2, "fp32": 4}


def work(role: str, c: dict) -> Tuple[float, float, str]:
    """(operations, bytes, precision) of one call of ``role``."""
    if role in ("attention_fwd", "attention_bwd"):
        B, S, H, D = c["B"], c["S"], c["H"], c["D"]
        t = B * S * H * D * DTYPE_BYTES[c["dt"]]
        lse = 2 * B * H * S * 4
        bias = c.get("bias", 0) * 4
        if role == "attention_fwd":
            return (4.0 * B * H * S * S * D,
                    4 * t + bias + (lse if c.get("lse") else 0), c["dt"])
        return 10.0 * B * H * S * S * D, 7 * t + lse + bias, c["dt"]
    if role in ("sparc_fwd", "sparc_bwd"):
        B, T, P, E = c["B"], c["T"], c["P"], c["E"]
        v, l, mask = 4 * B * P * E, 4 * B * T * E, 4 * B * T
        sim, rl, rv = 4 * B * T * P, 4 * B * T, 4 * B * P
        if role == "sparc_fwd":
            return 4.0 * B * T * P * E, v + 2 * l + mask + sim + rl + rv, "fp32"
        return 8.0 * B * T * P * E, 2 * v + 3 * l + mask + sim + rl + rv, "fp32"
    raise KeyError(f"no count for kernel role {role!r}")


def bound_seconds(role: str, call: dict) -> Tuple[float, str]:
    """The least time the card could take for one call, and what bounds it
    (``bytes`` or ``operations``)."""
    ops, nbytes, prec = work(role, call)
    t_ops, t_bytes = ops / PEAK_FLOPS[prec], nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
