"""Merkle Mountain Range (append-only accumulator).

Behavioral spec: crates/crypto/src/merkle/mmr/ —
  - full.rs   Mmr: append-only post-order node vector; open/open_at prove a
              leaf against the current or any earlier forest
  - peaks.rs  MmrPeaks: peak list + the padded Poseidon2 commitment
  - proof.rs  MmrProof {forest, position, merkle_path}
  - partial.rs PartialMmr: peaks + a subset of tracked (authenticated) leaves

The "forest" is the leaf count; its set bits are the heights of the perfect
peak trees, highest first.
"""

from __future__ import annotations

from typing import Iterable, Iterator

from ..hash import poseidon2_host as hp
from .nodes import MerkleError, MerklePath, Word, as_word, merge


def _tree_size(height: int) -> int:
    """Node count of a perfect tree with 2^height leaves in post-order form."""
    return (1 << (height + 1)) - 1


def peak_heights(forest: int) -> list[int]:
    """Heights of the peak trees, highest first."""
    return [i for i in range(forest.bit_length() - 1, -1, -1) if forest >> i & 1]


def leaf_to_peak(forest: int, pos: int) -> tuple[int, int, int, int]:
    """Locate leaf ``pos``: returns (peak_index, height, first_leaf_in_peak,
    node_offset_of_peak) within the post-order node vector."""
    if pos >= forest:
        raise MerkleError(f"position {pos} out of range for forest {forest}")
    leaf_start = 0
    node_off = 0
    for i, h in enumerate(peak_heights(forest)):
        span = 1 << h
        if pos < leaf_start + span:
            return i, h, leaf_start, node_off
        leaf_start += span
        node_off += _tree_size(h)
    raise AssertionError("unreachable")


class MmrProof:
    """Opening proof against a specific forest (mmr/proof.rs)."""

    def __init__(self, forest: int, position: int, merkle_path: MerklePath):
        self.forest = forest
        self.position = position
        self.merkle_path = merkle_path

    def peak_index(self) -> int:
        return leaf_to_peak(self.forest, self.position)[0]

    def relative_position(self) -> int:
        _, _, leaf_start, _ = leaf_to_peak(self.forest, self.position)
        return self.position - leaf_start


class MmrPeaks:
    """Peak roots + leaf count (mmr/peaks.rs)."""

    def __init__(self, num_leaves: int, peaks: list[Word]):
        if len(peaks) != num_leaves.bit_count():
            raise MerkleError("peak count must equal the number of set forest bits")
        self.num_leaves = num_leaves
        self.peaks = peaks

    def hash_peaks(self) -> Word:
        """Commitment: Poseidon2 sponge over [num_leaves, 0, 0, 0] ++ peaks,
        peaks zero-padded to ≥16 and to an even count (peaks.rs:126,162)."""
        num = len(self.peaks)
        padded = 16 if num < 16 else num + (num & 1)
        flat = [self.num_leaves, 0, 0, 0]
        for p in self.peaks:
            flat.extend(p)
        flat.extend([0] * ((padded - num) * 4))
        return tuple(hp.hash_elements_padded(flat))  # type: ignore[return-value]

    def verify(self, value: Word, opening: MmrProof) -> bool:
        if opening.forest != self.num_leaves:
            return False
        i, _, leaf_start, _ = leaf_to_peak(self.num_leaves, opening.position)
        root = opening.merkle_path.compute_root(opening.position - leaf_start, value)
        return self.peaks[i] == root

    def get_peak(self, opening: MmrProof) -> Word:
        return self.peaks[opening.peak_index()]


class Mmr:
    """Append-only MMR over a post-order node vector (mmr/full.rs)."""

    def __init__(self, leaves: Iterable[Iterable[int]] = ()):
        self.forest = 0
        self._nodes: list[Word] = []
        for leaf in leaves:
            self.add(leaf)

    def __len__(self) -> int:
        return self.forest

    def add(self, el: Iterable[int]) -> None:
        """Append a leaf; merge equal-height peaks right-to-left (full.rs:157)."""
        self._nodes.append(as_word(el))
        # After appending, merge while the low bits of forest form runs of 1s.
        right = self._nodes[-1]
        height = 0
        f = self.forest
        while f & 1:
            # Root of the equal-height tree immediately to the left.
            left = self._nodes[-(_tree_size(height) + 1)]
            right = merge(left, right)
            self._nodes.append(right)
            f >>= 1
            height += 1
        self.forest += 1

    def get(self, pos: int) -> Word:
        _, h, leaf_start, node_off = leaf_to_peak(self.forest, pos)
        return self._subtree_leaf(node_off, h, pos - leaf_start)

    def open(self, pos: int) -> MmrProof:
        return self.open_at(pos, self.forest)

    def open_at(self, pos: int, forest: int) -> MmrProof:
        """Prove leaf ``pos`` against the (possibly earlier) ``forest``.

        Valid because the node vector is append-only: the peak trees of any
        earlier forest are intact prefixes (full.rs:131).
        """
        if forest > self.forest:
            raise MerkleError(f"forest {forest} is in the future")
        _, h, leaf_start, node_off = leaf_to_peak(forest, pos)
        rel = pos - leaf_start
        siblings: list[Word] = []
        off, height = node_off, h
        while height > 0:
            left_size = _tree_size(height - 1)
            go_right = rel >> (height - 1) & 1
            left_off, right_off = off, off + left_size
            sib_off = left_off if go_right else right_off
            siblings.append(self._nodes[sib_off + left_size - 1])  # sibling root
            off = right_off if go_right else left_off
            height -= 1
        siblings.reverse()
        return MmrProof(forest, pos, MerklePath(siblings))

    def peaks(self) -> MmrPeaks:
        return self.peaks_at(self.forest)

    def peaks_at(self, forest: int) -> MmrPeaks:
        if forest > self.forest:
            raise MerkleError(f"forest {forest} is in the future")
        peaks: list[Word] = []
        off = 0
        for h in peak_heights(forest):
            size = _tree_size(h)
            peaks.append(self._nodes[off + size - 1])
            off += size
        return MmrPeaks(forest, peaks)

    def inner_nodes(self) -> Iterator[tuple[Word, Word, Word]]:
        """(parent, left, right) over every merged node."""
        off = 0
        for h in peak_heights(self.forest):
            yield from self._subtree_inner(off, h)
            off += _tree_size(h)

    def _subtree_inner(self, off: int, height: int):
        if height == 0:
            return
        left_size = _tree_size(height - 1)
        left_root = self._nodes[off + left_size - 1]
        right_root = self._nodes[off + 2 * left_size - 1]
        yield self._nodes[off + 2 * left_size], left_root, right_root
        yield from self._subtree_inner(off, height - 1)
        yield from self._subtree_inner(off + left_size, height - 1)

    def _subtree_leaf(self, off: int, height: int, rel: int) -> Word:
        while height > 0:
            left_size = _tree_size(height - 1)
            if rel >> (height - 1) & 1:
                off += left_size
            rel &= (1 << (height - 1)) - 1
            height -= 1
        return self._nodes[off]


class PartialMmr:
    """Peaks plus a subset of authenticated leaves (mmr/partial.rs).

    Supports tracking openings proved elsewhere, point queries, and appends
    (which keep tracked paths valid by extending them with newly formed
    siblings)."""

    def __init__(self, peaks: MmrPeaks, track_latest: bool = False):
        self.forest = peaks.num_leaves
        self._peaks = list(peaks.peaks)
        # leaf position -> (leaf value, path to its peak)
        self._tracked: dict[int, tuple[Word, list[Word]]] = {}
        self.track_latest = track_latest

    @staticmethod
    def from_peaks(peaks: MmrPeaks) -> "PartialMmr":
        return PartialMmr(peaks)

    def peaks(self) -> MmrPeaks:
        return MmrPeaks(self.forest, list(self._peaks))

    def is_tracked(self, pos: int) -> bool:
        return pos in self._tracked

    def track(self, pos: int, leaf: Word, path: MerklePath) -> None:
        """Start tracking an externally proven leaf."""
        i, h, leaf_start, _ = leaf_to_peak(self.forest, pos)
        if len(path.nodes) != h:
            raise MerkleError("path depth does not match peak height")
        if path.compute_root(pos - leaf_start, leaf) != self._peaks[i]:
            raise MerkleError("opening does not match tracked peak")
        self._tracked[pos] = (leaf, list(path.nodes))

    def untrack(self, pos: int) -> None:
        self._tracked.pop(pos, None)

    def open(self, pos: int) -> MmrProof:
        if pos not in self._tracked:
            raise MerkleError(f"leaf {pos} is not tracked")
        leaf, nodes = self._tracked[pos]
        return MmrProof(self.forest, pos, MerklePath(list(nodes)))

    def get(self, pos: int) -> Word:
        if pos not in self._tracked:
            raise MerkleError(f"leaf {pos} is not tracked")
        return self._tracked[pos][0]

    def add(self, el: Iterable[int], track: bool = False) -> None:
        """Append a leaf, merging peaks; tracked paths under merged peaks are
        extended with the newly adjacent sibling roots."""
        leaf = as_word(el)
        new_peaks = self._peaks + [leaf]
        heights = peak_heights(self.forest) + [0]
        new_tracked_path: list[Word] = []
        track_pos = self.forest
        # Merge equal-height peaks right-to-left, mirroring Mmr.add.
        while len(heights) >= 2 and heights[-1] == heights[-2]:
            right = new_peaks.pop()
            left = new_peaks.pop()
            h = heights.pop()
            heights.pop()
            heights.append(h + 1)
            merged = merge(left, right)
            # Leaves inside the left tree gain `right` as a sibling; inside
            # the right tree gain `left`.
            span = 1 << h
            boundary = self.forest + 1 - span  # first leaf pos of the right tree
            for pos, (lv, nodes) in self._tracked.items():
                if len(nodes) == h and boundary - span <= pos < boundary + span:
                    nodes.append(right if pos < boundary else left)
            if track:
                new_tracked_path.append(left if track_pos >= boundary else right)
            new_peaks.append(merged)
        self._peaks = new_peaks
        self.forest += 1
        if track:
            self._tracked[track_pos] = (leaf, new_tracked_path)
