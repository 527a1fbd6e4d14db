"""Dense and partial Merkle trees over Poseidon2 words.

``MerkleTree`` stores every layer (leaves last) like the reference
(crates/crypto/src/merkle/merkle_tree.rs); the lower layers of trees of
``_DEVICE_THRESHOLD`` leaves or more are folded as batched Poseidon2
compressions (``poseidon2.compress_rows``, K3's Merkle-layer kernel on the
card) on the tree's device until they are small enough that per-node host
hashing is cheaper.

``PartialMerkleTree`` (crates/crypto/src/merkle/partial_mt/mod.rs) tracks an
arbitrary set of authenticated leaves at mixed depths.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np

from .nodes import (
    EMPTY_WORD,
    MerkleError,
    MerklePath,
    NodeIndex,
    Word,
    as_word,
    merge,
)

# Below this many leaves the batched fold costs more than host hashing.
_DEVICE_THRESHOLD = 1024


def _build_layers_host(leaves: list[Word]) -> list[list[Word]]:
    layers = [leaves]
    while len(layers[-1]) > 1:
        prev = layers[-1]
        layers.append([merge(prev[i], prev[i + 1]) for i in range(0, len(prev), 2)])
    return layers


def _build_layers_device(leaves: list[Word], device) -> list[list[Word]]:
    from ..field import goldilocks as F
    from ..hash import poseidon2

    layers = [leaves]
    cur = F.to_torch(np.asarray(leaves, dtype=np.uint64), device)
    while cur.shape[0] > max(_DEVICE_THRESHOLD // 2, 1):
        cur = poseidon2.compress_rows(cur)
        layers.append([tuple(int(x) for x in row) for row in F.to_numpy(cur)])
    host = _build_layers_host(layers[-1])
    return layers + host[1:]


class MerkleTree:
    """Fully-balanced binary Merkle tree (merkle_tree.rs:24). ``device``
    folds the lower layers of a tree of ``_DEVICE_THRESHOLD`` leaves or more
    (the card unless the caller asks for ``"cpu"``); smaller trees hash on
    the host."""

    def __init__(self, leaves: Sequence[Iterable[int]], device="cuda"):
        n = len(leaves)
        if n < 2 or n & (n - 1):
            raise MerkleError(f"number of leaves must be a power of two ≥ 2, got {n}")
        words = [as_word(l) for l in leaves]
        # self._layers[0] = leaves, last = [root]
        if n >= _DEVICE_THRESHOLD:
            self._layers = _build_layers_device(words, device)
        else:
            self._layers = _build_layers_host(words)

    @property
    def root(self) -> Word:
        return self._layers[-1][0]

    @property
    def depth(self) -> int:
        return len(self._layers) - 1

    def num_leaves(self) -> int:
        return len(self._layers[0])

    def get_node(self, index: NodeIndex) -> Word:
        if index.depth > self.depth:
            raise MerkleError(f"depth {index.depth} exceeds tree depth {self.depth}")
        return self._layers[self.depth - index.depth][index.value]

    def get_path(self, index: NodeIndex) -> MerklePath:
        if index.depth > self.depth:
            raise MerkleError(f"depth {index.depth} exceeds tree depth {self.depth}")
        return MerklePath([self.get_node(s) for s in index.proof_indices()])

    def leaves(self) -> Iterator[tuple[int, Word]]:
        return enumerate(self._layers[0])

    def inner_nodes(self) -> Iterator[tuple[Word, Word, Word]]:
        """(parent, left, right) for every inner node."""
        for d in range(1, len(self._layers)):
            below = self._layers[d - 1]
            for i, parent in enumerate(self._layers[d]):
                yield parent, below[2 * i], below[2 * i + 1]

    def update_leaf(self, index: int, value: Iterable[int]) -> None:
        """Point update with O(depth) re-hashing (merkle_tree.rs:140)."""
        if index >= self.num_leaves():
            raise MerkleError(f"leaf index {index} out of bounds")
        node = as_word(value)
        for layer in self._layers[:-1]:
            layer[index] = node
            sib = layer[index ^ 1]
            node = merge(sib, node) if index & 1 else merge(node, sib)
            index >>= 1
        self._layers[-1][0] = node


class PartialMerkleTree:
    """Partial view of a Merkle tree of mixed-depth authenticated leaves
    (partial_mt/mod.rs). Backed by a node map keyed by NodeIndex; the root
    lives at depth 0."""

    def __init__(self) -> None:
        self._nodes: dict[NodeIndex, Word] = {}
        self._leaves: set[NodeIndex] = set()
        self._max_depth = 0

    @staticmethod
    def with_paths(paths: Iterable[tuple[int, Word, MerklePath]]) -> "PartialMerkleTree":
        pmt = PartialMerkleTree()
        for index, value, path in paths:
            pmt.add_path(index, value, path)
        return pmt

    @property
    def root(self) -> Word:
        return self._nodes.get(NodeIndex.root(), EMPTY_WORD)

    def max_depth(self) -> int:
        return self._max_depth

    def get_node(self, index: NodeIndex) -> Word:
        try:
            return self._nodes[index]
        except KeyError:
            raise MerkleError(f"node {index} not tracked") from None

    def is_leaf(self, index: NodeIndex) -> bool:
        return index in self._leaves

    def leaves(self) -> Iterator[tuple[NodeIndex, Word]]:
        return ((i, self._nodes[i]) for i in sorted(self._leaves))

    def get_path(self, index: NodeIndex) -> MerklePath:
        if index not in self._nodes:
            raise MerkleError(f"node {index} not tracked")
        nodes = []
        for sib in index.proof_indices():
            if sib not in self._nodes:
                raise MerkleError(f"sibling {sib} not tracked")
            nodes.append(self._nodes[sib])
        return MerklePath(nodes)

    def add_path(self, index_value: int, value: Word, path: MerklePath) -> None:
        """Absorb an authenticated (leaf, path) pair; all merges along the
        way become tracked inner nodes. Conflicting roots are rejected."""
        index = NodeIndex(path.depth, index_value)
        root = path.compute_root(index_value, value)
        cur_root = self._nodes.get(NodeIndex.root())
        if cur_root is not None and cur_root != root:
            raise MerkleError("path root differs from tracked root")

        self._max_depth = max(self._max_depth, index.depth)
        node = as_word(value)
        self._leaves.add(index)
        idx = index
        for sibling in path.nodes:
            self._nodes[idx] = node
            sib_idx = idx.sibling()
            if sib_idx not in self._nodes:
                self._nodes[sib_idx] = sibling
                self._leaves.add(sib_idx)
            # A sibling that previously looked like a leaf may now be interior.
            node = (
                merge(self._nodes[sib_idx], node)
                if not idx.is_left()
                else merge(node, self._nodes[sib_idx])
            )
            idx = idx.parent()
            self._leaves.discard(idx)
        self._nodes[NodeIndex.root()] = node

    def update_leaf(self, index: NodeIndex, value: Word) -> Word:
        """Update a tracked leaf, re-hash to the root; returns the old value."""
        if index not in self._leaves:
            raise MerkleError(f"{index} is not a tracked leaf")
        old = self._nodes[index]
        node = as_word(value)
        idx = index
        self._nodes[idx] = node
        while not idx.is_root():
            sib = self._nodes.get(idx.sibling())
            if sib is None:
                raise MerkleError(f"sibling {idx.sibling()} not tracked")
            node = merge(sib, node) if not idx.is_left() else merge(node, sib)
            idx = idx.parent()
            self._nodes[idx] = node
        return old

    def inner_nodes(self) -> Iterator[tuple[Word, Word, Word]]:
        for idx, value in self._nodes.items():
            l, r = idx.left_child(), idx.right_child()
            if l in self._nodes and r in self._nodes:
                yield value, self._nodes[l], self._nodes[r]
