"""Miden-shaped synthetic AIRs (the statement ``miden_tpu.bench_airs``
defines), for benchmarking and the port's end-to-end checks, and a statement
with preprocessed columns (:func:`square_lut_statement`).

A 51-column "core" AIR with an 8-EF-column LogUp aux block, a 22-column
"chiplets" AIR and a 16-column "poseidon2-permutation" AIR with a 16-row
periodic cycle: the widths, degree profile (max degree 3) and height mix of
the Miden VM multi-AIR. Constraints vanish on the all-zero main trace, so
any power-of-two height proves without a VM front-end.

The ``eval`` bodies are the JAX package's, unchanged: the folder backends
make them run on torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import gl
from .field import goldilocks as F
from .stark.air import Air, MultiAir


class CoreShapedAir(Air):
    """51 main columns + 8 EF aux columns (4 LogUp buses worth), degree ≤ 3."""

    width = 51
    aux_width = 8
    num_randomness = 2
    num_aux_values = 8
    num_public_values = 32

    def eval(self, f):
        w = self.width
        # degree-3 transition family across all columns (vanishes at 0)
        a = f.main_many(range(w))
        b = f.main_many([(c + 1) % w for c in range(w)])
        nxt = f.main_many(range(w), 1)
        f.assert_transition_many(nxt * a - a * a * b)
        # boundary families against the 32 public values
        head = f.main_many(range(16))
        f.assert_zero_first_row_many(head - f.public_many(range(16)))
        f.assert_zero_last_row_many(head - f.public_many(range(16, 32)))
        # aux running-sum constraints per EF column
        g0 = f.rand(0)
        g1 = f.rand(1)
        av = f.aux_many(range(self.aux_width))
        avn = f.aux_many(range(self.aux_width), 1)
        m0 = f.main_many(range(self.aux_width))
        m1 = f.main_many(range(self.aux_width), 1)
        f.assert_zero_first_row_many(av - (m0 * g1 + g0))
        f.assert_transition_many(avn - av - (m1 * g1 + g0))
        f.assert_zero_last_row_many(av - f.aux_value_many(range(self.aux_width)))

    def build_aux_trace(self, main, publics, aux_inputs, randomness):
        n = main.shape[0]
        g0, g1 = randomness  # device (2,) extension scalars
        # terms = γ0 + v·γ1 with v = main col c (zero here): one device
        # prefix scan builds all 8 columns
        from .stark.aux import running_sum_aux_columns

        terms = g0.expand(n, self.aux_width, 2)
        return running_sum_aux_columns(terms)  # (n, 16), final (8, 2)


class ChipletsShapedAir(Air):
    """22 main columns, degree ≤ 3, no aux."""

    width = 22
    num_public_values = 32

    def eval(self, f):
        w = self.width
        a = f.main_many(range(w))
        b = f.main_many([(c + 3) % w for c in range(w)])
        nxt = f.main_many(range(w), 1)
        f.assert_transition_many(nxt * b - a * a * b)
        f.assert_zero_first_row(f.main(0))


class PermShapedAir(Air):
    """16 main columns with a 16-row periodic cycle column, degree ≤ 3."""

    width = 16
    num_public_values = 32
    periodic_columns = [[1] + [0] * 15, [0] * 15 + [1]]

    def eval(self, f):
        p0 = f.periodic(0)
        p1 = f.periodic(1)
        a = f.main_many(range(self.width))
        nxt = f.main_many(range(self.width), 1)
        f.assert_zero_many(a * a * p0)
        f.assert_transition_many((nxt - a) * p1)


def miden_shaped_statement(log_core: int, device="cuda"):
    """The Miden height mix: core at 2^log_core, chiplets 4× shorter,
    poseidon2 16× shorter. Returns the statement and zero traces made on
    ``device``."""
    from .stark.prover import Statement

    airs = MultiAir([CoreShapedAir(), ChipletsShapedAir(), PermShapedAir()])

    def zeros(n, w):
        return torch.zeros((n, w), dtype=torch.int64, device=device)

    core = zeros(1 << log_core, 51)
    chip = zeros(1 << max(4, log_core - 2), 22)
    perm = zeros(1 << max(4, log_core - 4), 16)
    return Statement(airs, [0] * 32), [core, chip, perm]


class SquareLutAir(Air):
    """A fixed table of squares as a preprocessed column: row i holds
    i² mod p, and the one main column must equal it plus the public offset,
    read at both window offsets (the AIR of ``tests/test_preprocessed.py``
    and the reference's framework fixture,
    crates/lifted-stark/src/testing/test_preprocessed.rs), at 2^log_n rows."""

    width = 1
    preprocessed_width = 1
    num_public_values = 1

    def __init__(self, log_n: int):
        self.log_n = log_n

    def eval(self, f):
        f.assert_zero(f.main(0) - f.preprocessed(0) - f.public(0))
        f.assert_transition(f.main(0, 1) - f.preprocessed(0, 1) - f.public(0))

    def preprocessed_trace(self):
        i = np.arange(1 << self.log_n, dtype=object)
        return np.asarray((i * i) % gl.P, dtype=np.uint64)[:, None]


#: the public offset of :func:`square_lut_statement` (that of tests/test_preprocessed.py)
SQUARE_LUT_OFFSET = 3


def square_lut_statement(log_n: int, device="cuda"):
    """The one-AIR statement of :class:`SquareLutAir` at 2^log_n rows and the
    main trace that satisfies it (i² + SQUARE_LUT_OFFSET), made on ``device``."""
    from .stark.prover import Statement

    air = SquareLutAir(log_n)
    table = air.preprocessed_trace()
    trace = F.to_torch(
        np.asarray((table.astype(object) + SQUARE_LUT_OFFSET) % gl.P, dtype=np.uint64), device
    )
    return Statement(MultiAir([air]), [SQUARE_LUT_OFFSET]), [trace]
