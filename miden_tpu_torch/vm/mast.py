"""Merkelized Abstract Syntax Trees (MAST).

Behavioral spec: core/src/mast/ —
  - node kinds BasicBlock/Join/Split/Loop/Call(SysCall)/Dyn(DynCall)/External
    (core/src/mast/node/mod.rs:76-84)
  - basic-block op batching: ≤8 groups of ≤9 seven-bit opcodes per batch;
    immediates claim their own group; groups padded to power-of-two counts;
    block digest = Poseidon2 length-tagged sponge over every batch's 8 group
    felts (basic_block_node/{mod.rs:680, op_batch.rs:347})
  - control-node digests = merge_in_domain(child digests, opcode domain)
    (join_node.rs:114, split_node.rs:112, loop_node.rs:100, call_node.rs:128,
    dyn_node.rs:283)
  - assert-class error codes fingerprinted into the block digest out-of-band
    (basic_block_node/mod.rs:692 fingerprint_basic_block_error_codes)

Digests are host-side Words (tuples of 4 canonical felts) — the forest is a
host data structure feeding the device prover.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..hash import poseidon2_host as hp
from ..merkle.nodes import EMPTY_WORD, Word
from .ops import BATCH_SIZE, GROUP_SIZE, NOOP, OP_BITS, OPCODES, Op

ERROR_CODE_FINGERPRINT_DOMAIN = 0x2473_0001  # basic_block_node/mod.rs:39


def _merge_in_domain(a: Word, b: Word, domain: int) -> Word:
    return tuple(hp.merge_in_domain(list(a), list(b), domain))  # type: ignore


# ---------------------------------------------------------------------------
# Op batching (op_batch.rs OpBatchAccumulator semantics)
# ---------------------------------------------------------------------------


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


_ASSERT_CLASS = frozenset({"ASSERT", "U32ASSERT2", "MPVERIFY"})


def _fingerprint_error_codes(digest: Word, batches: list[OpBatch]) -> Word:
    """Mix assert-class error codes into the digest
    (basic_block_node/mod.rs:692): for every assert-class op, serialize
    raw_op_idx (u64 LE) + opcode (u8) + error code (u64 LE — Operation's
    Serializable impl, operations/mod.rs:808), then hash
    [domain, digest, len_lo, len_hi, packed u32 LE words of the data]."""
    data = bytearray()
    for idx, op in enumerate(op for b in batches for op in b.raw_ops()):
        if op.name in _ASSERT_CLASS:
            data += idx.to_bytes(8, "little")
            data += bytes([op.op_code])
            data += op.err_code.to_bytes(8, "little")
    if not data:
        return digest
    elements = [ERROR_CODE_FINGERPRINT_DOMAIN, *digest]
    elements.append(len(data) & 0xFFFFFFFF)
    elements.append(len(data) >> 32)
    for off in range(0, len(data), 4):
        elements.append(int.from_bytes(data[off : off + 4].ljust(4, b"\0"), "little"))
    return tuple(hp.hash_elements_padded(elements))  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclass
class BasicBlockNode:
    """A linear span of operations (basic_block_node/mod.rs). System events
    are ordinary `push.<event_id> emit drop` op sequences
    (crates/assembly/src/basic_block_builder.rs:139-142), so they enter
    batching and the digest like any other ops."""

    ops: list[Op]
    batches: list[OpBatch] = field(init=False)
    digest: Word = field(init=False)
    fingerprint: Word = field(init=False)

    def __post_init__(self):
        if not self.ops:
            self.ops = [NOOP]
        self.batches = batch_ops(self.ops)
        flat = [g for b in self.batches for g in b.groups]
        # The node digest is the PLAIN sequential hash of the op groups —
        # exactly what the hasher chiplet recomputes during decoding
        # (basic_block_node/mod.rs:680 batch_and_hash_ops). Error codes are
        # folded only into the forest-dedup fingerprint
        # (fingerprint_for_node, :841), never into the digest.
        self.digest = tuple(hp.hash_elements_padded(flat))
        self.fingerprint = _fingerprint_error_codes(self.digest, self.batches)

    children = ()

    def num_op_groups(self) -> int:
        last = self.batches[-1].num_groups
        pow2 = 1 << max(0, (last - 1).bit_length())
        return (len(self.batches) - 1) * BATCH_SIZE + pow2


@dataclass
class JoinNode:
    children: tuple[int, int]
    digest: Word = EMPTY_WORD

    DOMAIN = OPCODES["JOIN"]


@dataclass
class SplitNode:
    children: tuple[int, int]  # (on_true, on_false)
    digest: Word = EMPTY_WORD

    DOMAIN = OPCODES["SPLIT"]


@dataclass
class LoopNode:
    children: tuple[int]  # (body,)
    digest: Word = EMPTY_WORD

    DOMAIN = OPCODES["LOOP"]


@dataclass
class CallNode:
    children: tuple[int]  # (callee,)
    is_syscall: bool = False
    digest: Word = EMPTY_WORD

    CALL_DOMAIN = OPCODES["CALL"]
    SYSCALL_DOMAIN = OPCODES["SYSCALL"]


@dataclass
class DynNode:
    is_dyncall: bool = False
    digest: Word = EMPTY_WORD
    children = ()

    DYN_DOMAIN = OPCODES["DYN"]
    DYNCALL_DOMAIN = OPCODES["DYNCALL"]


@dataclass
class ExternalNode:
    """Reference to a procedure in another forest, by digest."""

    digest: Word
    children = ()


MastNode = (
    BasicBlockNode | JoinNode | SplitNode | LoopNode | CallNode | DynNode | ExternalNode
)


class MastForest:
    """A DAG of MAST nodes addressed by index, with named roots
    (core/src/mast/mod.rs)."""

    def __init__(self) -> None:
        self.nodes: list[MastNode] = []
        self._by_digest: dict[Word, int] = {}
        self._by_fingerprint: dict[Word, int] = {}
        self.roots: list[int] = []
        self.advice_map: dict[Word, list[int]] = {}

    def __getitem__(self, node_id: int) -> MastNode:
        return self.nodes[node_id]

    def _add(self, node: MastNode) -> int:
        # Dedup by fingerprint (digest + error-code data for basic blocks,
        # fingerprint_for_node, basic_block_node/mod.rs:841) so blocks that
        # differ only in assert error codes stay distinct; digest-keyed
        # resolution (External/Dyn) keeps the first node with each digest.
        # namespaced by node kind: an ExternalNode shares its digest with
        # the node it references, but must not dedup against it
        key = (type(node).__name__, getattr(node, "fingerprint", node.digest))
        existing = self._by_fingerprint.get(key)
        if existing is not None:
            return existing
        self.nodes.append(node)
        node_id = len(self.nodes) - 1
        self._by_fingerprint[key] = node_id
        # digest-keyed resolution (External/Dyn): prefer resolvable nodes —
        # a later-added real node overrides an ExternalNode placeholder that
        # shares its digest (host.load_library equivalent)
        cur = self._by_digest.get(node.digest)
        if cur is None or isinstance(self.nodes[cur], ExternalNode):
            self._by_digest[node.digest] = node_id
        return node_id

    def add_block(self, ops: list[Op]) -> int:
        return self._add(BasicBlockNode(ops))

    def add_join(self, left: int, right: int) -> int:
        digest = _merge_in_domain(
            self.nodes[left].digest, self.nodes[right].digest, JoinNode.DOMAIN
        )
        return self._add(JoinNode((left, right), digest))

    def add_split(self, on_true: int, on_false: int) -> int:
        digest = _merge_in_domain(
            self.nodes[on_true].digest, self.nodes[on_false].digest, SplitNode.DOMAIN
        )
        return self._add(SplitNode((on_true, on_false), digest))

    def add_loop(self, body: int) -> int:
        digest = _merge_in_domain(self.nodes[body].digest, EMPTY_WORD, LoopNode.DOMAIN)
        return self._add(LoopNode((body,), digest))

    def add_call(self, callee: int, is_syscall: bool = False) -> int:
        domain = CallNode.SYSCALL_DOMAIN if is_syscall else CallNode.CALL_DOMAIN
        digest = _merge_in_domain(self.nodes[callee].digest, EMPTY_WORD, domain)
        return self._add(CallNode((callee,), is_syscall, digest))

    def add_dyn(self, is_dyncall: bool = False) -> int:
        domain = DynNode.DYNCALL_DOMAIN if is_dyncall else DynNode.DYN_DOMAIN
        digest = _merge_in_domain(EMPTY_WORD, EMPTY_WORD, domain)
        return self._add(DynNode(is_dyncall, digest))

    def add_external(self, digest: Word) -> int:
        return self._add(ExternalNode(tuple(digest)))

    def make_root(self, node_id: int) -> None:
        if node_id not in self.roots:
            self.roots.append(node_id)

    def find_root(self, digest: Word) -> int | None:
        node_id = self._by_digest.get(tuple(digest))
        return node_id if node_id in self.roots else None


@dataclass
class Program:
    """An executable: a forest plus its entrypoint (core/src/program/)."""

    forest: MastForest
    entrypoint: int
    kernel_digests: tuple[Word, ...] = ()

    @property
    def hash(self) -> Word:
        return self.forest[self.entrypoint].digest
