"""Lifted Matrix Commitment Scheme (LMCS), Poseidon2 configuration.

One Merkle tree commits to several matrices of power-of-two heights
(``miden_tpu.merkle.lmcs``; reference crates/lifted-stark/src/lmcs/).
Shorter matrices are lifted to the max height by cyclic repetition in
natural domain order: domain index ``d`` reads row ``d mod h``.

- Leaf ``d``: overwrite-mode Poseidon2 sponge over the row of every matrix
  at ``d mod h``, each row zero-padded to the rate (alignment 8). The sponge
  streams rate-8 column blocks of each matrix in turn
  (:func:`_sponge_leaves_incremental`); the lifted, padded concatenation of
  all matrices is never built. On the card each matrix is one launch of
  K3's ``poseidon2_absorb_rows``.
- Inner layers: truncated-permutation 2-to-1 compression of neighbours, one
  ``poseidon2_compress_rows`` launch per layer on the card.
- Openings: the full sibling path per query is gathered on the device
  (:func:`gather_query_data`) and the deduplicated witness of
  :func:`sibling_schedule` is selected on the host
  (:func:`emit_opening_hints`); :func:`verify_batch` replays it.

Only the Poseidon2 configuration is ported. The RPO/RPX/BLAKE3/Keccak
configurations of ``miden_tpu`` come with the slice that ports the device
data hashes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..field.goldilocks import to_numpy
from ..hash import poseidon2, poseidon2_host

ALIGNMENT = 8  # sponge rate; rows are zero-padded to a multiple of this


@dataclass(frozen=True)
class LmcsHash:
    """Hash configuration: the device compression of a layer plus host
    twins for the verifier. Leaves absorb through Poseidon2's row sponge."""

    name: str
    compress_rows: object  # (2m, 4) -> (m, 4): rows 2i, 2i + 1 -> row i
    host_hash_elements: object  # list[int] -> [4]
    host_compress: object  # ([4], [4]) -> [4]


POSEIDON2_HASH = LmcsHash(
    "poseidon2",
    poseidon2.compress_rows,
    poseidon2_host.hash_elements,
    poseidon2_host.compress,
)


def _not_ported(name: str):
    def config():
        raise NotImplementedError(
            f"the {name} LMCS configuration is not ported yet: it comes with "
            "the slice that ports the device data hashes (RPO/RPX/BLAKE3/Keccak)"
        )

    return config


HASH_CONFIGS = {
    "poseidon2": lambda: POSEIDON2_HASH,
    "rpo256": _not_ported("rpo256"),
    "rpx256": _not_ported("rpx256"),
    "blake3_256": _not_ported("blake3_256"),
    "keccak256": _not_ported("keccak256"),
}


def aligned_width(w: int) -> int:
    return ((w + ALIGNMENT - 1) // ALIGNMENT) * ALIGNMENT


@dataclass
class LmcsTree:
    """Prover-side committed tree: ``matrices`` (natural domain order, int64
    tensors) and digest ``layers`` bottom-up, ``layers[0]`` the leaves and
    ``layers[-1]`` the (1, 4) root."""

    matrices: list
    heights: list
    widths: list
    layers: list

    @property
    def height(self) -> int:
        return max(self.heights)

    def root(self) -> np.ndarray:
        return to_numpy(self.layers[-1])[0]

    def root_dev(self) -> torch.Tensor:
        """Root digest as a device (4,) tensor — no host sync."""
        return self.layers[-1][0]


def _sponge_leaves_incremental(matrices: list, heights: list, max_h: int) -> torch.Tensor:
    """Leaf digests ``(max_h, 4)``: the sponge state ``(12, max_h)`` absorbs
    each matrix's rate-8 column blocks in turn, each block lifted to max_h
    rows; the ragged tail block is zero-padded. Equal to hashing the lifted,
    padded concatenation since every aligned width is a multiple of the rate."""
    assert all(m.shape[0] == h for m, h in zip(matrices, heights))
    state = torch.zeros((12, max_h), dtype=torch.int64, device=matrices[0].device)
    for m in matrices:
        state = poseidon2.absorb_rows(state, m)
    return state[:4].T.contiguous()


def _fold_layers(h: LmcsHash, leaves: torch.Tensor) -> list:
    layers = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = h.compress_rows(cur)
        layers.append(cur)
    return layers


def build_tree(matrices: Sequence[torch.Tensor], hash: LmcsHash = POSEIDON2_HASH) -> LmcsTree:
    """Commit to matrices (natural domain order, power-of-two heights that
    divide the max height)."""
    matrices = list(matrices)
    heights = [m.shape[0] for m in matrices]
    widths = [m.shape[1] for m in matrices]
    max_h = max(heights)
    for h in heights:
        assert max_h % h == 0 and (h & (h - 1)) == 0, "heights must be powers of two"
    leaves = _sponge_leaves_incremental(matrices, heights, max_h)
    layers = _fold_layers(hash, leaves)
    return LmcsTree(matrices=matrices, heights=heights, widths=widths, layers=layers)


# ---------------------------------------------------------------------------
# Batch opening (shared sibling schedule)
# ---------------------------------------------------------------------------


def sibling_schedule(indices: Sequence[int], depth: int) -> list:
    """Deduplicated Merkle witness schedule: the ``(level, node_index)`` list
    of sibling digests the verifier cannot derive, in a fixed order."""
    frontier = sorted(set(indices))
    needed = []
    for level in range(depth):
        parents = set(frontier)
        for i in frontier:
            sib = i ^ 1
            if sib not in parents:
                needed.append((level, sib))
        frontier = sorted({i >> 1 for i in frontier})
    return needed


def gather_query_data(tree: LmcsTree, idx: torch.Tensor) -> tuple:
    """Device gather for :func:`emit_opening_hints`. ``idx``: (q,) int64
    tensor of raw query indices in this tree's domain order (duplicates
    allowed). Returns one flat tensor
    ``[rows per matrix (q·aw)...][sibling paths (depth·q·4)]`` and its meta."""
    parts = []
    for m, h in zip(tree.matrices, tree.heights):
        w = m.shape[1]
        if w == 0:
            continue
        rows = m.index_select(0, torch.remainder(idx, h))  # (q, w)
        aw = aligned_width(w)
        if aw > w:
            rows = torch.nn.functional.pad(rows, (0, aw - w))
        parts.append(rows.reshape(-1))
    depth = len(tree.layers) - 1
    for level in range(depth):
        sib = torch.bitwise_xor(idx >> level, 1)
        parts.append(tree.layers[level].index_select(0, sib).reshape(-1))
    flat = torch.cat(parts)
    return flat, (
        int(idx.shape[0]),
        [aligned_width(w) for w in tree.widths if w],
        depth,
        [h for w, h in zip(tree.widths, tree.heights) if w],
    )


def emit_opening_hints(channel, host_vals: np.ndarray, meta, raw_indices) -> None:
    """Feed a read-back :func:`gather_query_data` buffer into the channel
    hint stream in the canonical batch-opening layout: aligned rows per
    sorted-unique index per matrix, then the deduplicated sibling digests of
    :func:`sibling_schedule`."""
    q, aws, depth, heights = meta
    raw = [int(v) for v in raw_indices]
    assert len(raw) == q
    uniq = sorted(set(raw))
    first_pos: dict = {}
    for j, d in enumerate(raw):
        first_pos.setdefault(d, j)

    mat_off = []
    off = 0
    for aw in aws:
        mat_off.append(off)
        off += q * aw
    sib_base = off
    for d in uniq:
        for m_i, aw in enumerate(aws):
            base = mat_off[m_i] + first_pos[d] * aw
            channel.hint_field_slice([int(v) for v in host_vals[base : base + aw]])
    sched = sibling_schedule(uniq, depth)
    by_level: dict = {}
    for level in range(depth):
        lv = {}
        for d in uniq:
            lv.setdefault(d >> level, first_pos[d])
        by_level[level] = lv
    for level, node in sched:
        j = by_level[level][node ^ 1]
        base = sib_base + (level * q + j) * 4
        channel.hint_commitment(tuple(int(v) for v in host_vals[base : base + 4]))
    assert sib_base + depth * q * 4 == len(host_vals)


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
