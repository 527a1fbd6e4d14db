"""LMCS (lifted mixed-matrix commitment) batch openings, verifier side:
recompute the leaves of the opened rows and fold them with the hinted
siblings to the committed root. A copy of the host half of the port's
``merkle/lmcs.py`` for its algebraic hashes (Poseidon2, RPO-256, RPX-256);
building trees is the prover's, not copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from . import poseidon2 as poseidon2_host
from . import rescue as rescue_host

ALIGNMENT = 8  # sponge rate; rows are zero-padded to a multiple of this


@dataclass(frozen=True)
class LmcsHash:
    """The host leaf hash and layer compression of one width-12
    permutation (reference: per-hash LMCS types, air/src/config.rs:236-353)."""

    name: str
    host_hash_elements: object  # list[int] -> [4]
    host_compress: object  # ([4], [4]) -> [4]


POSEIDON2_HASH = LmcsHash("poseidon2", poseidon2_host.hash_elements, poseidon2_host.compress)
RPO_HASH = LmcsHash("rpo256", rescue_host.rpo_hash_elements_stateful, rescue_host.rpo_compress)
RPX_HASH = LmcsHash("rpx256", rescue_host.rpx_hash_elements_stateful, rescue_host.rpx_compress)

HASH_CONFIGS = {
    "poseidon2": lambda: POSEIDON2_HASH,
    "rpo256": lambda: RPO_HASH,
    "rpx256": lambda: RPX_HASH,
}


def aligned_width(w: int) -> int:
    return ((w + ALIGNMENT - 1) // ALIGNMENT) * ALIGNMENT


def verify_batch(
    commitment,
    widths: Sequence[int],
    max_height: int,
    indices: Sequence[int],
    channel,
    hash: LmcsHash = POSEIDON2_HASH,
) -> dict:
    """Verifier side of a batch opening: reads hinted rows and sibling
    digests from ``channel``, recomputes the leaves and folds to the root;
    raises ``ValueError`` on mismatch. Returns
    ``{index: [row_per_matrix (unpadded numpy u64)]}``."""
    indices = sorted(set(indices))
    depth = (max_height - 1).bit_length()
    rows_by_index: dict = {}
    leaf_digest: dict = {}
    for d in indices:
        rows = []
        stream = []
        for w in widths:
            aw = aligned_width(w)
            row = channel.read_hint_fields(aw)
            stream.extend(row)
            rows.append(np.asarray(row[:w], dtype=np.uint64))
        rows_by_index[d] = rows
        leaf_digest[d] = tuple(hash.host_hash_elements([int(v) for v in stream]))

    nodes = {(0, d): leaf_digest[d] for d in indices}
    frontier = indices
    for level in range(depth):
        parents_set = set(frontier)
        for i in frontier:
            sib = i ^ 1
            if sib not in parents_set:
                nodes[(level, sib)] = tuple(channel.read_hint_commitment())
        next_frontier = sorted({i >> 1 for i in frontier})
        for p in next_frontier:
            left = nodes[(level, 2 * p)]
            right = nodes[(level, 2 * p + 1)]
            nodes[(level + 1, p)] = tuple(hash.host_compress(list(left), list(right)))
        frontier = next_frontier
    root = nodes[(depth, 0)]
    if tuple(int(v) for v in commitment) != root:
        raise ValueError("LMCS root mismatch")
    return rows_by_index
