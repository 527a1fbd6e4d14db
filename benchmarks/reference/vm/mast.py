"""MAST digests of a program: Poseidon2 over a basic block's op batches,
and a join of two nodes (core/src/mast/; basic_block_node/{mod.rs:680,
op_batch.rs:347}, join_node.rs:114).

Basic-block op batching: <=8 groups of <=9 seven-bit opcodes per batch;
immediates claim their own group; groups padded to power-of-two counts;
block digest = Poseidon2 length-tagged sponge over every batch's 8 group
felts. A copy of the op batching of the port's ``vm/mast.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import poseidon2 as hp
from .ops import BATCH_SIZE, GROUP_SIZE, NOOP, OP_BITS, OPCODES, Op


@dataclass
class OpBatch:
    ops: list[Op]  # including padding noops
    groups: list[int]  # BATCH_SIZE felts: packed opcodes / immediates
    indptr: list[int]  # group i spans ops[indptr[i]:indptr[i+1]]
    padding: list[bool]
    num_groups: int

    def raw_ops(self):
        for g in range(self.num_groups):
            end = self.indptr[g + 1] - (1 if self.padding[g] else 0)
            yield from self.ops[self.indptr[g] : end]


class _Accumulator:
    _INVALID = BATCH_SIZE * GROUP_SIZE + 1

    def __init__(self) -> None:
        self.ops: list[Op] = []
        self.indptr = [0] * (BATCH_SIZE + 1)
        self.padding = [False] * BATCH_SIZE
        self.groups = [0] * BATCH_SIZE
        self.group = 0
        self.op_idx = 0
        self.group_idx = 0
        self.next_group_idx = 1

    def is_empty(self) -> bool:
        return not self.ops

    def can_accept(self, op: Op) -> bool:
        if op.imm_value is not None:
            if self.op_idx < GROUP_SIZE - 1:
                return self.next_group_idx < BATCH_SIZE
            return self.next_group_idx + 1 < BATCH_SIZE
        return self.op_idx < GROUP_SIZE or self.next_group_idx < BATCH_SIZE

    def add(self, op: Op) -> None:
        if self.op_idx == GROUP_SIZE:
            self._finalize_group()
        if op.imm_value is not None:
            # An immediate-carrying op can't end a group (the decoder reads
            # the immediate from the *next* group).
            if self.op_idx == GROUP_SIZE - 1:
                self._finalize_group()
            self.groups[self.next_group_idx] = op.imm_value
            self.indptr[self.next_group_idx] = self._INVALID
            self.next_group_idx += 1
        self._push(op)

    def into_batch(self) -> OpBatch:
        target = 1 << max(0, (self.next_group_idx - 1).bit_length())
        if target < self.next_group_idx:
            target = self.next_group_idx
        for _ in range(self.next_group_idx, target):
            self._finalize_group()
        if self.group != 0 or self.op_idx != 0:
            self.groups[self.group_idx] = self.group
        self._pad_if_needed()
        self._finalize_indptr()
        for i in range(self.next_group_idx, BATCH_SIZE + 1):
            self.indptr[i] = len(self.ops)
        return OpBatch(
            self.ops, list(self.groups), list(self.indptr), list(self.padding),
            self.next_group_idx,
        )

    def _push(self, op: Op) -> None:
        self.group |= op.op_code << (OP_BITS * self.op_idx)
        self.ops.append(op)
        self.op_idx += 1

    def _pad_if_needed(self) -> None:
        if self.op_idx == 0 or (self.ops and self.ops[-1].imm_value is not None):
            self._push(NOOP)
            self.padding[self.group_idx] = True

    def _finalize_group(self) -> None:
        self._pad_if_needed()
        self.groups[self.group_idx] = self.group
        self._finalize_indptr()
        self.group_idx = self.next_group_idx
        self.next_group_idx = self.group_idx + 1
        self.op_idx = 0
        self.group = 0

    def _finalize_indptr(self) -> None:
        self.indptr[self.next_group_idx] = len(self.ops)
        i = self.next_group_idx - 1
        while i >= self.group_idx and self.indptr[i] == self._INVALID:
            self.indptr[i] = len(self.ops)
            i -= 1


def batch_ops(ops: list[Op]) -> list[OpBatch]:
    """Pack operations into batches (basic_block_node/mod.rs:722)."""
    batches: list[OpBatch] = []
    acc = _Accumulator()
    for op in ops:
        if not acc.can_accept(op):
            batches.append(acc.into_batch())
            acc = _Accumulator()
        acc.add(op)
    if not acc.is_empty():
        batches.append(acc.into_batch())
    return batches


def block_digest(ops: list) -> tuple:
    """The digest of a basic block: the plain sequential hash of its op
    groups, as the hasher chiplet recomputes it while decoding."""
    flat = [g for b in batch_ops(ops or [NOOP]) for g in b.groups]
    return tuple(hp.hash_elements_padded(flat))


def join_digest(left: tuple, right: tuple) -> tuple:
    return tuple(hp.merge_in_domain(list(left), list(right), OPCODES["JOIN"]))
