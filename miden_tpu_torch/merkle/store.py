"""MerkleStore: an in-memory DAG of Merkle nodes addressed by digest.

Behavioral spec: crates/crypto/src/merkle/store/mod.rs. Nodes are stored as
``digest → (left_child_digest, right_child_digest)``; any number of trees
(dense, partial, sparse, MMR peaks) share structure in one store. Paths are
resolved by descending from a root digest, so the same store serves every
root it has ever absorbed — this is what backs the VM advice provider's
Merkle operations (mtree_get/mtree_set/mtree_merge).
"""

from __future__ import annotations

from typing import Iterable, Iterator

from .nodes import (
    EmptySubtreeRoots,
    MerkleError,
    MerklePath,
    NodeIndex,
    Word,
    as_word,
    merge,
)

_MAX_DEPTH = 64


class MerkleStore:
    def __init__(self) -> None:
        # digest -> (left, right); pre-seeded with empty-subtree chain so
        # sparse trees traverse without materializing empty nodes.
        self._nodes: dict[Word, tuple[Word, Word]] = {}
        chain = EmptySubtreeRoots._chain()
        for h in range(1, _MAX_DEPTH + 1):
            self._nodes[chain[h]] = (chain[h - 1], chain[h - 1])

    # -- queries ----------------------------------------------------------

    def num_internal_nodes(self) -> int:
        return len(self._nodes)

    def get_node(self, root: Word, index: NodeIndex) -> Word:
        node = root
        for bit in range(index.depth - 1, -1, -1):
            children = self._nodes.get(node)
            if children is None:
                raise MerkleError(f"node {node} not in store")
            node = children[index.value >> bit & 1]
        return node

    def get_path(self, root: Word, index: NodeIndex) -> tuple[Word, MerklePath]:
        """Returns (leaf_value, path), path deepest-first (store/mod.rs:159)."""
        node = root
        siblings: list[Word] = []
        for bit in range(index.depth - 1, -1, -1):
            children = self._nodes.get(node)
            if children is None:
                raise MerkleError(f"node {node} not in store")
            go = index.value >> bit & 1
            siblings.append(children[1 - go])
            node = children[go]
        siblings.reverse()
        return node, MerklePath(siblings)

    def has_path(self, root: Word, index: NodeIndex) -> bool:
        try:
            self.get_path(root, index)
            return True
        except MerkleError:
            return False

    def get_leaf_depth(self, root: Word, tree_depth: int, index: int) -> int:
        """Depth of the first un-expandable node on the path to ``index``
        in a tree of ``tree_depth`` (store/mod.rs:230)."""
        if index >> tree_depth:
            raise MerkleError("index out of bounds")
        node = root
        for d in range(tree_depth):
            children = self._nodes.get(node)
            if children is None:
                return d
            node = children[index >> (tree_depth - 1 - d) & 1]
        return tree_depth

    def inner_nodes(self) -> Iterator[tuple[Word, Word, Word]]:
        for parent, (l, r) in self._nodes.items():
            yield parent, l, r

    def subset(self, roots: Iterable[Word]) -> "MerkleStore":
        out = MerkleStore()
        stack = [as_word(r) for r in roots]
        seen: set[Word] = set()
        while stack:
            node = stack.pop()
            if node in seen:
                continue
            seen.add(node)
            children = self._nodes.get(node)
            if children is not None:
                out._nodes[node] = children
                stack.extend(children)
        return out

    # -- mutation ---------------------------------------------------------

    def add(self, parent: Word, left: Word, right: Word) -> None:
        self._nodes[parent] = (left, right)

    def extend(self, inner_nodes: Iterable[tuple[Word, Word, Word]]) -> None:
        """Absorb (parent, left, right) triples — the `inner_nodes()`
        iterator of MerkleTree / PartialMerkleTree / Smt / Mmr."""
        for parent, left, right in inner_nodes:
            self._nodes[parent] = (left, right)

    def add_merkle_path(self, index_value: int, node: Word, path: MerklePath) -> Word:
        """Absorb an authenticated path; returns the computed root
        (store/mod.rs:416)."""
        idx = index_value
        for sibling in path.nodes:
            if idx & 1:
                parent = merge(sibling, node)
                self._nodes[parent] = (sibling, node)
            else:
                parent = merge(node, sibling)
                self._nodes[parent] = (node, sibling)
            node = parent
            idx >>= 1
        return node

    def add_merkle_paths(self, paths: Iterable[tuple[int, Word, MerklePath]]) -> None:
        for index, node, path in paths:
            self.add_merkle_path(index, node, path)

    def set_node(self, root: Word, index: NodeIndex, value: Word) -> Word:
        """Copy-on-write point update; returns the new root (store/mod.rs:458).
        The old tree remains addressable by its old root."""
        leaf, path = self.get_path(root, index)
        if leaf == value:
            return root
        return self.add_merkle_path(index.value, value, path)

    def merge_roots(self, left_root: Word, right_root: Word) -> Word:
        parent = merge(left_root, right_root)
        self._nodes[parent] = (left_root, right_root)
        return parent
