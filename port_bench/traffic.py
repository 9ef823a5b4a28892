"""Open-loop request traffic from the seed (numpy only: the load generator's
child process imports no torch).

Every seed gets the same work: ``round(rate · seconds)`` requests, whose
sizes are the mix's sizes in the mix's proportions exactly, and whose gaps
are one fixed set of exponential quantiles (a Poisson process's gaps at
``rate``), both in one fixed shuffled order. The seed draws the bank of
random images and each request's images from it. (A shuffle by the seed
gave each seed its own bursts: at 0.8 of the knee the p95 of six seeds
then spread over 333-629 ms.)
"""

from __future__ import annotations

from typing import List

import numpy as np

ORDER = 20240501


def image_bank(seed: int, count: int, size: int) -> np.ndarray:
    """``count`` random uint8 [size, size, 3] images."""
    rng = np.random.default_rng([seed, 7])
    return rng.integers(0, 256, (count, size, size, 3), dtype=np.uint8)


def schedule(seed: int, rate: float, seconds: float, sizes: List[int],
             weights: List[float], bank: int) -> dict:
    """``due`` [N] seconds from the window's start, ``images`` [N] lists of
    bank rows, for requests offered at ``rate`` a second over ``seconds``."""
    order = np.random.default_rng(ORDER)
    rng = np.random.default_rng([seed, 11])
    n = max(1, int(round(rate * seconds)))
    counts = np.floor(np.asarray(weights) / np.sum(weights) * n).astype(int)
    for i in np.argsort(-np.asarray(weights))[: n - counts.sum()]:
        counts[i] += 1
    size = order.permutation(np.repeat(sizes, counts))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.concatenate([[0.0], np.cumsum(order.permutation(gaps))[:-1]])
    images = [rng.integers(0, bank, int(k)).tolist() for k in size]
    return {"due": due.tolist(), "images": images}


def sample(seed: int, sched: dict, count: int, longest: int) -> List[int]:
    """The requests whose answers are compared: every one of the largest
    size up to ``longest`` of them, then others drawn from the seed, up to
    ``count`` in all."""
    rng = np.random.default_rng([seed, 13])
    n_img = np.array([len(x) for x in sched["images"]])
    big = np.flatnonzero(n_img == n_img.max())
    chosen = list(rng.permutation(big)[:longest])
    rest = np.setdiff1d(np.arange(len(n_img)), chosen)
    chosen += list(rng.permutation(rest)[: max(0, count - len(chosen))])
    return sorted(int(i) for i in chosen)
