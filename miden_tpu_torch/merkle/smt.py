"""Sparse Merkle trees: generic-depth ``SimpleSmt`` and the depth-64
key-value ``Smt``.

Behavioral spec: crates/crypto/src/merkle/smt/ —
  - simple/mod.rs   SimpleSmt<DEPTH>: word leaves, empty-subtree defaults
  - full/mod.rs     Smt (SMT_DEPTH=64): leaf index = key[3]; leaves hold
                    sorted (key, value) entry lists hashed in LEAF_DOMAIN
  - full/leaf.rs    SmtLeaf::{Empty,Single,Multiple} hashing
  - full/proof.rs   SmtProof = (path, leaf)

Only non-empty nodes are stored; absent nodes fall back to
``EmptySubtreeRoots``. All hashing is host-side Poseidon2 (these structures
back the advice provider, not the proving hot path).
"""

from __future__ import annotations

import bisect
from typing import Iterable, Iterator, Sequence

from ..hash import poseidon2_host as hp
from .nodes import (
    EMPTY_WORD,
    EmptySubtreeRoots,
    MerkleError,
    MerklePath,
    NodeIndex,
    Word,
    as_word,
    merge,
    word_key,
)

SMT_DEPTH = 64
LEAF_DOMAIN = 0x13AF  # crates/crypto/src/merkle/smt/mod.rs:71
MAX_LEAF_ENTRIES = 1024


class _SparseStore:
    """Shared node storage for sparse trees: map NodeIndex → Word with
    empty-subtree fallback and O(depth) leaf updates."""

    def __init__(self, depth: int) -> None:
        if not (1 <= depth <= 64):
            raise MerkleError(f"depth must be in [1, 64], got {depth}")
        self.depth = depth
        self._nodes: dict[NodeIndex, Word] = {}

    def get_node(self, index: NodeIndex) -> Word:
        if index.depth > self.depth:
            raise MerkleError(f"depth {index.depth} exceeds tree depth {self.depth}")
        got = self._nodes.get(index)
        if got is not None:
            return got
        return EmptySubtreeRoots.entry(self.depth, index.depth)

    def get_path(self, leaf_value: int) -> MerklePath:
        index = NodeIndex(self.depth, leaf_value)
        return MerklePath([self.get_node(s) for s in index.proof_indices()])

    def set_leaf_hash(self, leaf_value: int, node: Word) -> None:
        idx = NodeIndex(self.depth, leaf_value)
        empty = EmptySubtreeRoots
        while True:
            if node == empty.entry(self.depth, idx.depth):
                self._nodes.pop(idx, None)
            else:
                self._nodes[idx] = node
            if idx.is_root():
                return
            sib = self.get_node(idx.sibling())
            node = merge(sib, node) if not idx.is_left() else merge(node, sib)
            idx = idx.parent()

    @property
    def root(self) -> Word:
        return self.get_node(NodeIndex.root())


class SimpleSmt:
    """Sparse Merkle tree with word leaves at a fixed depth
    (smt/simple/mod.rs). Leaves not explicitly set read as EMPTY_WORD."""

    def __init__(self, depth: int, entries: Iterable[tuple[int, Iterable[int]]] = ()):
        self._store = _SparseStore(depth)
        self._leaves: dict[int, Word] = {}
        for key, value in entries:
            self.insert(key, value)

    @property
    def depth(self) -> int:
        return self._store.depth

    @property
    def root(self) -> Word:
        return self._store.root

    def num_leaves(self) -> int:
        return len(self._leaves)

    def get_leaf(self, key: int) -> Word:
        self._check_key(key)
        return self._leaves.get(key, EMPTY_WORD)

    def get_node(self, index: NodeIndex) -> Word:
        return self._store.get_node(index)

    def open(self, key: int) -> tuple[MerklePath, Word]:
        self._check_key(key)
        return self._store.get_path(key), self.get_leaf(key)

    def insert(self, key: int, value: Iterable[int]) -> Word:
        """Set leaf ``key`` to ``value`` (EMPTY_WORD deletes); returns the
        previous value."""
        self._check_key(key)
        word = as_word(value)
        old = self._leaves.get(key, EMPTY_WORD)
        if word == EMPTY_WORD:
            self._leaves.pop(key, None)
        else:
            self._leaves[key] = word
        self._store.set_leaf_hash(key, word)
        return old

    def leaves(self) -> Iterator[tuple[int, Word]]:
        return iter(sorted(self._leaves.items()))

    def _check_key(self, key: int) -> None:
        if key >> self.depth:
            raise MerkleError(f"key {key} out of range for depth {self.depth}")


class SmtLeaf:
    """Leaf of the full SMT: a key-sorted list of (key, value) entries
    (smt/full/leaf.rs). Empty ⇒ EMPTY_WORD; single ⇒ merge_in_domain;
    multiple ⇒ domain-tagged sponge over flattened entries."""

    def __init__(self, entries: Sequence[tuple[Word, Word]] = ()):
        self.entries = sorted(entries, key=lambda kv: word_key(kv[0]))

    def hash(self) -> Word:
        if not self.entries:
            return EMPTY_WORD
        if len(self.entries) == 1:
            k, v = self.entries[0]
            return tuple(hp.merge_in_domain(list(k), list(v), LEAF_DOMAIN))  # type: ignore
        flat = [x for k, v in self.entries for x in (*k, *v)]
        return tuple(hp.hash_elements_padded(flat, LEAF_DOMAIN))  # type: ignore

    def get_value(self, key: Word) -> Word:
        for k, v in self.entries:
            if k == key:
                return v
        return EMPTY_WORD

    def num_entries(self) -> int:
        return len(self.entries)


class SmtProof:
    """Opening proof: the leaf (with all its entries) plus the Merkle path
    (smt/full/proof.rs)."""

    def __init__(self, path: MerklePath, leaf: SmtLeaf):
        self.path = path
        self.leaf = leaf

    def verify_membership(self, key: Word, value: Word, root: Word) -> bool:
        if self.leaf.get_value(key) != value:
            return False
        index = smt_leaf_index(key)
        return self.path.verify(index, self.leaf.hash(), root)

    def compute_root(self, key: Word) -> Word:
        return self.path.compute_root(smt_leaf_index(key), self.leaf.hash())


def smt_leaf_index(key: Word) -> int:
    """Leaf position of a key: its most-significant felt, key[3]
    (smt/full/mod.rs:562)."""
    return key[3]


class Smt:
    """Full key-value SMT at depth 64 (smt/full/mod.rs:32)."""

    def __init__(self, entries: Iterable[tuple[Iterable[int], Iterable[int]]] = ()):
        self._store = _SparseStore(SMT_DEPTH)
        self._leaves: dict[int, SmtLeaf] = {}
        for key, value in entries:
            self.insert(key, value)

    @property
    def root(self) -> Word:
        return self._store.root

    def num_leaves(self) -> int:
        return len(self._leaves)

    def num_entries(self) -> int:
        return sum(l.num_entries() for l in self._leaves.values())

    def get_value(self, key: Iterable[int]) -> Word:
        k = as_word(key)
        leaf = self._leaves.get(smt_leaf_index(k))
        return leaf.get_value(k) if leaf else EMPTY_WORD

    def get_leaf(self, key: Iterable[int]) -> SmtLeaf:
        return self._leaves.get(smt_leaf_index(as_word(key)), SmtLeaf())

    def open(self, key: Iterable[int]) -> SmtProof:
        k = as_word(key)
        index = smt_leaf_index(k)
        return SmtProof(self._store.get_path(index), self.get_leaf(k))

    def insert(self, key: Iterable[int], value: Iterable[int]) -> Word:
        """Insert/update (EMPTY_WORD value deletes); returns the old value."""
        k, v = as_word(key), as_word(value)
        index = smt_leaf_index(k)
        leaf = self._leaves.get(index, SmtLeaf())
        old = leaf.get_value(k)
        entries = [(ek, ev) for ek, ev in leaf.entries if ek != k]
        if v != EMPTY_WORD:
            bisect.insort(entries, (k, v), key=lambda kv: word_key(kv[0]))
            if len(entries) > MAX_LEAF_ENTRIES:
                raise MerkleError("leaf entry budget exceeded")
        new_leaf = SmtLeaf(entries)
        if new_leaf.entries:
            self._leaves[index] = new_leaf
        else:
            self._leaves.pop(index, None)
        self._store.set_leaf_hash(index, new_leaf.hash())
        return old

    def entries(self) -> Iterator[tuple[Word, Word]]:
        for index in sorted(self._leaves):
            yield from self._leaves[index].entries

    def leaves(self) -> Iterator[tuple[int, SmtLeaf]]:
        return iter(sorted(self._leaves.items()))
