"""Lifted Matrix Commitment Scheme (LMCS): the Poseidon2, RPO-256,
RPX-256, BLAKE3-256 and Keccak-256 configurations.

One Merkle tree commits to several matrices of power-of-two heights
(``miden_tpu.merkle.lmcs``; reference crates/lifted-stark/src/lmcs/).
Shorter matrices are lifted to the max height by cyclic repetition in
natural domain order: domain index ``d`` reads row ``d mod h``.

- Leaf ``d``: the configuration's overwrite-mode sponge over the row of
  every matrix at ``d mod h``, each row zero-padded to the rate (alignment
  8). The sponge streams rate-8 column blocks of each matrix in turn
  (:func:`_sponge_leaves_incremental`); the lifted, padded concatenation of
  all matrices is never built. On the card each matrix is one launch of the
  permutation's ``absorb_rows`` kernel (K3, R1 or R2).
- Inner layers: truncated-permutation 2-to-1 compression of neighbours, one
  ``compress_rows`` launch per layer on the card.
- Openings: the full sibling path per query is gathered on the device
  (:func:`gather_query_data`) and the deduplicated witness of
  :func:`sibling_schedule` is selected on the host
  (:func:`emit_opening_hints`); :func:`verify_batch` replays it.

Each configuration absorbs its leaves with its own permutation. This is
where the port departs from ``miden_tpu``: there
``_sponge_leaves_incremental`` (``miden_tpu/merkle/lmcs.py:373``) absorbs
every algebraic configuration's leaves with Poseidon2 while its verifier
rehashes them with the configuration's own host sponge, so its rpo256 and
rpx256 proofs do not verify.

The BLAKE3-256 and Keccak-256 configurations (:func:`blake3_hash`,
:func:`keccak_hash`) hash whole rows instead: every matrix is lifted and
zero-padded to the alignment, the rows are concatenated
(:func:`_lift_pad_concat`), and each leaf is the byte hash of its row's LE
u64 bytes. A digest is 32 bytes carried as four LE u64 words, which are
arbitrary u64s, not field elements: int64 holds them bit for bit. These
trees serve as data commitments only; ``PcsParams`` rejects them for the
proof pipeline, as ``miden_tpu``'s does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..field.goldilocks import to_numpy
from ..hash import blake3, blake3_host, keccak, keccak_host, poseidon2, poseidon2_host, rescue, rescue_host

ALIGNMENT = 8  # sponge rate; rows are zero-padded to a multiple of this


@dataclass(frozen=True)
class LmcsHash:
    """Hash configuration (reference: per-hash LMCS types,
    air/src/config.rs:236-353): the device leaf sponge and layer compression
    of one width-12 permutation, plus host twins for the verifier."""

    name: str
    absorb_rows: object  # (state (12, max_h), m (h, w)) -> state: the leaf sponge
    compress_rows: object  # (2m, 4) -> (m, 4): rows 2i, 2i + 1 -> row i
    host_hash_elements: object  # list[int] -> [4]
    host_compress: object  # ([4], [4]) -> [4]
    #: byte hashes: (max_h, W) lifted, padded rows -> (max_h, 4) leaves,
    #: used instead of the sponge ``absorb_rows`` (None for the sponges)
    hash_rows: object = None


POSEIDON2_HASH = LmcsHash(
    "poseidon2",
    poseidon2.absorb_rows,
    poseidon2.compress_rows,
    poseidon2_host.hash_elements,
    poseidon2_host.compress,
)
RPO_HASH = LmcsHash(
    "rpo256",
    rescue.RPO.absorb_rows,
    rescue.RPO.compress_rows,
    rescue_host.rpo_hash_elements_stateful,
    rescue_host.rpo_compress,
)
RPX_HASH = LmcsHash(
    "rpx256",
    rescue.RPX.absorb_rows,
    rescue.RPX.compress_rows,
    rescue_host.rpx_hash_elements_stateful,
    rescue_host.rpx_compress,
)


def _words_to_u64(d8: torch.Tensor) -> torch.Tensor:
    """(n, 8) LE 32-bit words -> (n, 4) LE u64 words (bits in int64)."""
    return d8[:, 0::2] | (d8[:, 1::2] << 32)


def _u64_to_words(d4: torch.Tensor) -> torch.Tensor:
    """(n, 4) u64 words -> (n, 8) LE 32-bit words."""
    return torch.stack([d4 & 0xFFFFFFFF, (d4 >> 32) & 0xFFFFFFFF], dim=2).reshape(-1, 8)


def _byte_hash(name: str, dev_mod, host_mod) -> LmcsHash:
    """BLAKE3-256 / Keccak-256 trees (``miden_tpu/merkle/lmcs.py:80-120``):
    the leaf is the byte hash of the whole lifted, padded row; a layer
    merges ``hash(left_bytes || right_bytes)``."""

    def hash_rows(flat: torch.Tensor) -> torch.Tensor:
        return _words_to_u64(dev_mod.hash_felt_rows(flat))

    def compress_rows(cur: torch.Tensor) -> torch.Tensor:
        pairs = _u64_to_words(cur).view(-1, 16)
        return _words_to_u64(dev_mod.compress_pairs(pairs[:, :8], pairs[:, 8:]))

    def words(digest: bytes) -> list:
        return [int.from_bytes(digest[i : i + 8], "little") for i in range(0, 32, 8)]

    def host_hash_elements(elements):
        return words(host_mod.hash_elements(list(elements)))

    def host_compress(a, b):
        return words(host_mod.merge(*(b"".join(int(w).to_bytes(8, "little") for w in d) for d in (a, b))))

    return LmcsHash(name, None, compress_rows, host_hash_elements, host_compress, hash_rows)


BLAKE3_HASH = _byte_hash("blake3_256", blake3, blake3_host)
KECCAK_HASH = _byte_hash("keccak256", keccak, keccak_host)

HASH_CONFIGS = {
    "poseidon2": lambda: POSEIDON2_HASH,
    "rpo256": lambda: RPO_HASH,
    "rpx256": lambda: RPX_HASH,
    "blake3_256": lambda: BLAKE3_HASH,
    "keccak256": lambda: KECCAK_HASH,
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


def _sponge_leaves_incremental(
    h: LmcsHash, matrices: list, heights: list, max_h: int
) -> torch.Tensor:
    """Leaf digests ``(max_h, 4)``: the sponge state ``(12, max_h)`` of the
    configuration ``h`` absorbs each matrix's rate-8 column blocks in turn,
    each block lifted to max_h rows; the ragged tail block is zero-padded.
    Equal to hashing the lifted, padded concatenation since every aligned
    width is a multiple of the rate."""
    assert all(m.shape[0] == ht for m, ht in zip(matrices, heights))
    state = torch.zeros((12, max_h), dtype=torch.int64, device=matrices[0].device)
    for m in matrices:
        state = h.absorb_rows(state, m)
    return state[:4].T.contiguous()


def _lift_pad_concat(matrices: list, heights: list, max_h: int) -> torch.Tensor:
    """Every matrix lifted to max_h rows by cyclic repetition, its width
    zero-padded to the alignment, concatenated along columns: (max_h, W)."""
    parts = []
    for m, h in zip(matrices, heights):
        if max_h > h:
            m = m.repeat(max_h // h, 1)
        pad = aligned_width(m.shape[1]) - m.shape[1]
        parts.append(torch.nn.functional.pad(m, (0, pad)) if pad else m)
    return torch.cat(parts, dim=1)


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
    if hash.hash_rows is None:
        leaves = _sponge_leaves_incremental(hash, matrices, heights, max_h)
    else:
        leaves = hash.hash_rows(_lift_pad_concat(matrices, heights, max_h))
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
