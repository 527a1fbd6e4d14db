"""Merkle subsystem.

- ``lmcs``: the proving-path commitment scheme (device-batched, lifted
  multi-matrix trees).
- host data structures backing the VM advice provider and MAST layer
  (crates/crypto/src/merkle): dense/partial trees, sparse Merkle trees,
  MMR, and the digest-addressed MerkleStore.
"""

from . import lmcs  # noqa: F401
from .mmr import Mmr, MmrPeaks, MmrProof, PartialMmr  # noqa: F401
from .nodes import (  # noqa: F401
    EMPTY_WORD,
    EmptySubtreeRoots,
    MerkleError,
    MerklePath,
    NodeIndex,
    SparseMerklePath,
    Word,
    as_word,
    int_to_word,
    merge,
)
from .smt import SMT_DEPTH, SimpleSmt, Smt, SmtLeaf, SmtProof  # noqa: F401
from .store import MerkleStore  # noqa: F401
from .tree import MerkleTree, PartialMerkleTree  # noqa: F401
