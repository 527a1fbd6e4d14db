"""Preprocessed data: fixed per-AIR matrices and their committed LDE tree
(``miden_tpu.stark.preprocessed``).

Preprocessed columns are fixed circuit data (lookup tables, selectors)
declared by an :class:`~.air.Air` through ``preprocessed_trace()`` and
committed once at setup. The prover holds the raw matrices and their LDE
tree; the verifier holds only the commitment, a trusted setup input like the
AIR list itself, observed into Fiat-Shamir before the statement.

Reference: crates/lifted-stark/src/preprocessed.rs (Preprocessed::build,
validate_preprocessed).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import gl
from ..field import goldilocks as F
from ..merkle import lmcs
from ..ntt import ntt
from .params import PcsParams


@dataclass
class Preprocessed:
    """``traces[i]`` is the raw matrix (numpy u64) of AIR ``i`` (instance
    order), None where the AIR declares none. ``tree`` commits one LDE per
    preprocessed AIR, sorted by (height, air index): the committed order both
    sides reproduce (preprocessed.rs:100-113)."""

    traces: list
    tree: lmcs.LmcsTree
    order: list  # instance indices of the preprocessed AIRs, committed order

    def commitment(self) -> tuple:
        return tuple(int(v) for v in self.tree.root())

    def trace_index_for_air(self) -> dict:
        """Instance AIR index -> committed preprocessed trace index."""
        return {air_idx: t for t, air_idx in enumerate(self.order)}


def build_preprocessed(statement, params: PcsParams, device="cuda"):
    """Build the bundle from a statement's AIRs on ``device``, or None when
    no AIR declares preprocessed columns (Preprocessed::build)."""
    airs = statement.multi_air.airs
    traces = [a.preprocessed_trace() for a in airs]
    if all(t is None for t in traces):
        return None
    pairs = [(i, np.asarray(t, dtype=np.uint64)) for i, t in enumerate(traces) if t is not None]
    for i, t in pairs:
        n, w = t.shape
        assert n & (n - 1) == 0, f"AIR {i}: preprocessed height not a power of two"
        assert w == airs[i].preprocessed_width, (
            f"AIR {i}: preprocessed width {w} != declared {airs[i].preprocessed_width}"
        )
    pairs.sort(key=lambda p: (p[1].shape[0], p[0]))
    ldes = []
    for _, t in pairs:
        shift = gl.canonical_lde_shift((t.shape[0].bit_length() - 1) + params.log_blowup)
        ldes.append(ntt.coset_lde(F.to_torch(t, device), params.log_blowup, shift))
    tree = lmcs.build_tree(ldes, hash=params.lmcs_hash())
    return Preprocessed(traces=traces, tree=tree, order=[i for i, _ in pairs])


def validate_preprocessed(statement, traces, preprocessed: Preprocessed, params: PcsParams) -> None:
    """Shape checks at prove time (validate_preprocessed,
    preprocessed.rs:160): presence parity per AIR, width against the
    declaration, height against the main trace, committed LDE height against
    this configuration's blowup."""
    airs = statement.multi_air.airs
    if len(preprocessed.traces) != len(airs):
        raise ValueError("preprocessed raw trace count mismatch")
    for i, (a, raw) in enumerate(zip(airs, preprocessed.traces)):
        if (raw is not None) != (a.preprocessed_width > 0):
            raise ValueError(f"AIR {i}: preprocessed presence mismatch")
        if raw is None:
            continue
        raw = np.asarray(raw)
        if raw.shape[1] != a.preprocessed_width:
            raise ValueError(f"AIR {i}: preprocessed width mismatch")
        if raw.shape[0] != traces[i].shape[0]:
            raise ValueError(
                f"AIR {i}: preprocessed height {raw.shape[0]} != main trace "
                f"height {traces[i].shape[0]}"
            )
    for t, air_idx in enumerate(preprocessed.order):
        exp_h = traces[air_idx].shape[0] << params.log_blowup
        if preprocessed.tree.heights[t] != exp_h:
            raise ValueError(
                f"preprocessed trace {t}: committed LDE height "
                f"{preprocessed.tree.heights[t]} != expected {exp_h}"
            )
        if preprocessed.tree.widths[t] != airs[air_idx].preprocessed_width:
            raise ValueError(f"preprocessed trace {t}: committed width mismatch")
