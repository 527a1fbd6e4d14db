"""Device-side auxiliary (LogUp) traces.

A LogUp running-sum column is an inclusive prefix sum of extension
elements. :func:`prefix_sum_ext` computes it exactly mod p with a log-depth
(Hillis–Steele) scan of field adds: ``torch.cumsum`` on int64 does not
reduce mod p.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as F


def prefix_sum_ext(terms: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 of extension (or base) elements."""
    acc = terms
    k = 1
    while k < acc.shape[0]:
        acc = torch.cat([acc[:k], F.add(acc[k:], acc[:-k])])
        k <<= 1
    return acc


def running_sum_aux(terms: torch.Tensor):
    """1-column LogUp aux trace from per-row ext terms (n, 2): returns
    (aux numpy (n, 1, 2) u64, [final (c0, c1)]) in the
    ``Air.build_aux_trace`` contract."""
    pairs = F.to_numpy(prefix_sum_ext(terms))
    final = (int(pairs[-1, 0]), int(pairs[-1, 1]))
    return pairs[:, None, :].astype(np.uint64), [final]


def running_sum_aux_columns(terms: torch.Tensor):
    """All aux columns at once: terms (n, k, 2) ext → interleaved base matrix
    (n, 2k) ready for commitment, plus the final row (k, 2)."""
    acc = prefix_sum_ext(terms)
    n, k, _ = acc.shape
    return acc.reshape(n, 2 * k), acc[n - 1]
