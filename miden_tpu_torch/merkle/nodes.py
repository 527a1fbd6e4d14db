"""Merkle primitives: words, node indices, paths, empty-subtree roots.

Host-side data model for the Merkle structures used by the VM's advice
provider and the MAST/program layer. A digest ("word") is a tuple of 4
canonical Goldilocks ints — small, hashable, dict-key friendly; bulk tree
construction is batched in ``tree.py``.

Reference surface (behavioral spec, not a translation):
  - crates/crypto/src/merkle/index.rs        (NodeIndex)
  - crates/crypto/src/merkle/path.rs         (MerklePath)
  - crates/crypto/src/merkle/sparse_path.rs  (SparseMerklePath)
  - crates/crypto/src/merkle/empty_roots.rs  (EmptySubtreeRoots)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Iterable, Iterator, Sequence

from ..field import gl
from ..hash import poseidon2_host as hp

Word = tuple[int, int, int, int]

EMPTY_WORD: Word = (0, 0, 0, 0)

MAX_DEPTH = 64


def as_word(values: Iterable[int]) -> Word:
    """Canonicalize 4 ints into a Word."""
    w = tuple(int(v) % gl.P for v in values)
    if len(w) != 4:
        raise ValueError(f"a word has exactly 4 elements, got {len(w)}")
    return w  # type: ignore[return-value]


def int_to_word(value: int) -> Word:
    return (value % gl.P, 0, 0, 0)


def word_key(w: Word) -> tuple[int, ...]:
    """Total order on words: compare elements most-significant-last first
    (crates/field/src/word/mod.rs:317 — reverse element order)."""
    return tuple(reversed(w))


def merge(left: Word, right: Word) -> Word:
    return tuple(hp.merge(list(left), list(right)))  # type: ignore[return-value]


class MerkleError(Exception):
    """Merkle structure error (crates/crypto/src/merkle/error.rs)."""


@dataclass(frozen=True, order=True)
class NodeIndex:
    """Address of a node: ``depth`` (root = 0) and left-to-right ``value``.

    Mirrors crates/crypto/src/merkle/index.rs:63.
    """

    depth: int
    value: int

    def __post_init__(self) -> None:
        if not (0 <= self.depth <= MAX_DEPTH):
            raise MerkleError(f"depth {self.depth} out of range")
        if self.value >> self.depth:
            raise MerkleError(f"node value {self.value} too large for depth {self.depth}")

    @staticmethod
    def make(depth: int, position: int) -> "NodeIndex":
        return NodeIndex(depth, position)

    @staticmethod
    def root() -> "NodeIndex":
        return NodeIndex(0, 0)

    def is_root(self) -> bool:
        return self.depth == 0

    def is_left(self) -> bool:
        return self.value & 1 == 0

    def parent(self) -> "NodeIndex":
        return NodeIndex(max(self.depth - 1, 0), self.value >> 1)

    def parent_at(self, depth: int) -> "NodeIndex":
        if depth > self.depth:
            raise MerkleError("cannot move up to a deeper node")
        return NodeIndex(depth, self.value >> (self.depth - depth))

    def sibling(self) -> "NodeIndex":
        return NodeIndex(self.depth, self.value ^ 1)

    def left_child(self) -> "NodeIndex":
        return NodeIndex(self.depth + 1, self.value << 1)

    def right_child(self) -> "NodeIndex":
        return NodeIndex(self.depth + 1, (self.value << 1) | 1)

    def proof_indices(self) -> Iterator["NodeIndex"]:
        """Sibling indices along the path to the root, deepest first
        (index.rs:194)."""
        idx = self
        while not idx.is_root():
            yield idx.sibling()
            idx = idx.parent()


@dataclass
class MerklePath:
    """Siblings from a leaf (deepest first) up to the root's children
    (crates/crypto/src/merkle/path.rs)."""

    nodes: list[Word]

    @property
    def depth(self) -> int:
        return len(self.nodes)

    def compute_root(self, index: int, node: Word) -> Word:
        """Fold the path upward from ``node`` at leaf position ``index``."""
        if index >> len(self.nodes):
            raise MerkleError(f"index {index} too large for path depth {len(self.nodes)}")
        for sibling in self.nodes:
            node = merge(sibling, node) if index & 1 else merge(node, sibling)
            index >>= 1
        return node

    def verify(self, index: int, node: Word, root: Word) -> bool:
        return self.compute_root(index, node) == root

    def inner_nodes(self, index: int, node: Word) -> Iterator[tuple[Word, Word, Word]]:
        """Yield (parent, left, right) triples along the authenticated path."""
        for sibling in self.nodes:
            left, right = (sibling, node) if index & 1 else (node, sibling)
            node = merge(left, right)
            index >>= 1
            yield node, left, right


@dataclass
class SparseMerklePath:
    """A MerklePath with empty-subtree siblings elided
    (crates/crypto/src/merkle/sparse_path.rs): ``empty_nodes_mask`` bit k set
    ⇒ the sibling at depth (from-leaf position) k is the empty subtree root."""

    empty_nodes_mask: int
    nodes: list[Word]  # the non-empty siblings, deepest first

    @staticmethod
    def from_path(tree_depth: int, path: MerklePath) -> "SparseMerklePath":
        mask = 0
        dense: list[Word] = []
        for k, sibling in enumerate(path.nodes):
            node_depth = tree_depth - k
            if sibling == EmptySubtreeRoots.entry(tree_depth, node_depth):
                mask |= 1 << k
            else:
                dense.append(sibling)
        return SparseMerklePath(mask, dense)

    def to_path(self, tree_depth: int) -> MerklePath:
        out: list[Word] = []
        it = iter(self.nodes)
        depth = tree_depth
        k = 0
        while depth > 0:
            if self.empty_nodes_mask >> k & 1:
                out.append(EmptySubtreeRoots.entry(tree_depth, depth))
            else:
                out.append(next(it))
            depth -= 1
            k += 1
        return MerklePath(out)


class EmptySubtreeRoots:
    """Roots of all-empty subtrees (crates/crypto/src/merkle/empty_roots.rs).

    ``entry(tree_depth, node_depth)`` = root of an empty subtree of height
    ``tree_depth - node_depth`` (so entry(d, d) = EMPTY_WORD).
    """

    @staticmethod
    @lru_cache(maxsize=1)
    def _chain() -> list[Word]:
        # _chain()[h] = root of empty subtree of height h, h in [0, MAX_DEPTH+1]
        out = [EMPTY_WORD]
        for _ in range(256):
            out.append(merge(out[-1], out[-1]))
        return out

    @staticmethod
    def entry(tree_depth: int, node_depth: int) -> Word:
        if node_depth > tree_depth:
            raise MerkleError("node depth below tree depth")
        return EmptySubtreeRoots._chain()[tree_depth - node_depth]

    @staticmethod
    def empty_hashes(tree_depth: int) -> Sequence[Word]:
        """Roots indexed by node depth 0..tree_depth (root first)."""
        chain = EmptySubtreeRoots._chain()
        return [chain[tree_depth - d] for d in range(tree_depth + 1)]
