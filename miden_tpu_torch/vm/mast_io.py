"""Budgeted MAST forest / program serialization.

Wire form for compiled programs with untrusted-input hardening, covering
the reference's budgeted MAST deserialization
(core/src/mast/mod.rs:14-42, core/src/mast/serialization/): explicit
size caps *before* any allocation-proportional work, structural
validation (children must precede their parents — the forest is built
append-only, so any valid wire form is already topologically ordered),
and digest *recomputation* on read — node digests are never trusted
from the wire, so a tampered payload changes the program hash instead
of forging it.

Format (little-endian):

  magic "MTFR" | version u32 | n_nodes u32 | nodes... |
  n_roots u32 | roots u32... | n_advice u32 | advice entries... |
  [program trailer: entrypoint u32 | n_kernel u32 | kernel digests]

  node := tag u8 | payload
    0 basic block: n_ops u32 | per op (opcode u8 | flags u8 |
      imm u64 if flag&1 | err u64 if flag&2)
    1 join / 2 split: two u32 children
    3 loop: one u32 child
    4 call: child u32 | is_syscall u8
    5 dyn: is_dyncall u8
    6 external: digest 4 x u64
"""

from __future__ import annotations

import struct

from ..field import gl
from .mast import (
    BasicBlockNode,
    CallNode,
    DynNode,
    ExternalNode,
    JoinNode,
    LoopNode,
    MastForest,
    Program,
    SplitNode,
)
from .ops import OPCODES, Op

MAGIC = b"MTFR"
VERSION = 1

# budgets enforced before allocation-proportional work
MAX_BYTES = 64 * 1024 * 1024
MAX_NODES = 1 << 20
MAX_TOTAL_OPS = 1 << 22
# one block may hold the whole op budget: the assembler unrolls ``repeat.n``
# into one block, and bench.py's real program (``repeat.84000``, 252,000
# ops) must load from the bytes ``forest_to_bytes`` writes for it.
# miden_tpu caps a block at 2^16 ops, so it writes that program's wire form
# and then refuses to read it; the total budget already bounds the work.
MAX_OPS_PER_BLOCK = MAX_TOTAL_OPS
MAX_ADVICE_ENTRIES = 1 << 16
MAX_ADVICE_VALUES = 1 << 22

_OP_BY_CODE = {v: k for k, v in OPCODES.items()}


class MastFormatError(ValueError):
    pass


def _put_word(out: bytearray, word) -> None:
    out += struct.pack("<4Q", *[int(v) % gl.P for v in word])


def forest_to_bytes(forest: MastForest, _trailer: bytes = b"") -> bytes:
    out = bytearray()
    out += MAGIC
    out += struct.pack("<II", VERSION, len(forest.nodes))
    for node in forest.nodes:
        if isinstance(node, BasicBlockNode):
            out += struct.pack("<BI", 0, len(node.ops))
            for op in node.ops:
                flags = (op.imm is not None) | ((op.err_code != 0) << 1)
                out += struct.pack("<BB", OPCODES[op.name], flags)
                if op.imm is not None:
                    out += struct.pack("<Q", int(op.imm) % gl.P)
                if op.err_code:
                    out += struct.pack("<Q", op.err_code)
        elif isinstance(node, JoinNode):
            out += struct.pack("<BII", 1, *node.children)
        elif isinstance(node, SplitNode):
            out += struct.pack("<BII", 2, *node.children)
        elif isinstance(node, LoopNode):
            out += struct.pack("<BI", 3, node.children[0])
        elif isinstance(node, CallNode):
            out += struct.pack("<BIB", 4, node.children[0], node.is_syscall)
        elif isinstance(node, DynNode):
            out += struct.pack("<BB", 5, node.is_dyncall)
        elif isinstance(node, ExternalNode):
            out += struct.pack("<B", 6)
            _put_word(out, node.digest)
        else:  # pragma: no cover - closed node union
            raise MastFormatError(f"unknown node {type(node).__name__}")
    out += struct.pack("<I", len(forest.roots))
    for r in forest.roots:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(forest.advice_map))
    for word, values in forest.advice_map.items():
        _put_word(out, word)
        out += struct.pack("<I", len(values))
        for v in values:
            out += struct.pack("<Q", int(v) % gl.P)
    out += _trailer
    return bytes(out)


def program_to_bytes(program: Program) -> bytes:
    trailer = bytearray()
    trailer += struct.pack(
        "<II", program.entrypoint, len(program.kernel_digests)
    )
    for d in program.kernel_digests:
        _put_word(trailer, d)
    return forest_to_bytes(program.forest, bytes(trailer))


class _Reader:
    """Bounds-checked cursor: every read validates remaining length first."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.off + size > len(self.data):
            raise MastFormatError("truncated input")
        vals = struct.unpack_from(fmt, self.data, self.off)
        self.off += size
        return vals

    def word(self):
        w = self.take("<4Q")
        if any(v >= gl.P for v in w):
            raise MastFormatError("non-canonical digest element")
        return tuple(w)


def forest_from_bytes(data: bytes) -> tuple[MastForest, _Reader, list[int]]:
    """Rebuild a forest, recomputing every digest; returns the forest, the
    reader positioned at the trailer (for program_from_bytes), and the
    wire-id -> rebuilt-id map (dedup may collapse duplicate nodes)."""
    if len(data) > MAX_BYTES:
        raise MastFormatError("input exceeds 64 MiB cap")
    rd = _Reader(data)
    if bytes(rd.take("<4s")[0]) != MAGIC:
        raise MastFormatError("bad magic")
    version, n_nodes = rd.take("<II")
    if version != VERSION:
        raise MastFormatError(f"unsupported version {version}")
    if n_nodes > MAX_NODES:
        raise MastFormatError("node budget exceeded")

    forest = MastForest()
    idmap: list[int] = []  # wire id -> rebuilt id (dedup may collapse)
    total_ops = 0
    for wire_id in range(n_nodes):
        (tag,) = rd.take("<B")
        if tag == 0:
            (n_ops,) = rd.take("<I")
            if n_ops > MAX_OPS_PER_BLOCK:
                raise MastFormatError("basic block op budget exceeded")
            total_ops += n_ops
            if total_ops > MAX_TOTAL_OPS:
                raise MastFormatError("total op budget exceeded")
            ops = []
            for _ in range(n_ops):
                code, flags = rd.take("<BB")
                name = _OP_BY_CODE.get(code)
                if name is None or flags > 3:
                    raise MastFormatError("unknown opcode or flags")
                imm = rd.take("<Q")[0] if flags & 1 else None
                err = rd.take("<Q")[0] if flags & 2 else 0
                try:
                    ops.append(Op(name, imm, err))
                except ValueError as e:
                    raise MastFormatError(str(e)) from e
            new_id = forest.add_block(ops)
        elif tag in (1, 2):
            a, b = rd.take("<II")
            if a >= wire_id or b >= wire_id:
                raise MastFormatError("child does not precede parent")
            add = forest.add_join if tag == 1 else forest.add_split
            new_id = add(idmap[a], idmap[b])
        elif tag == 3:
            (c,) = rd.take("<I")
            if c >= wire_id:
                raise MastFormatError("child does not precede parent")
            new_id = forest.add_loop(idmap[c])
        elif tag == 4:
            c, sysc = rd.take("<IB")
            if c >= wire_id or sysc > 1:
                raise MastFormatError("bad call node")
            new_id = forest.add_call(idmap[c], bool(sysc))
        elif tag == 5:
            (dyn,) = rd.take("<B")
            if dyn > 1:
                raise MastFormatError("bad dyn node")
            new_id = forest.add_dyn(bool(dyn))
        elif tag == 6:
            new_id = forest.add_external(rd.word())
        else:
            raise MastFormatError(f"unknown node tag {tag}")
        idmap.append(new_id)

    (n_roots,) = rd.take("<I")
    if n_roots > n_nodes:
        raise MastFormatError("root budget exceeded")
    for _ in range(n_roots):
        (r,) = rd.take("<I")
        if r >= n_nodes:
            raise MastFormatError("root out of range")
        forest.roots.append(idmap[r])

    (n_adv,) = rd.take("<I")
    if n_adv > MAX_ADVICE_ENTRIES:
        raise MastFormatError("advice budget exceeded")
    total_vals = 0
    for _ in range(n_adv):
        key = rd.word()
        (n_vals,) = rd.take("<I")
        total_vals += n_vals
        if total_vals > MAX_ADVICE_VALUES:
            raise MastFormatError("advice value budget exceeded")
        vals = []
        for _ in range(n_vals):
            (v,) = rd.take("<Q")
            if v >= gl.P:
                raise MastFormatError("non-canonical advice element")
            vals.append(v)
        forest.advice_map[key] = vals
    return forest, rd, idmap


def program_from_bytes(data: bytes) -> Program:
    forest, rd, idmap = forest_from_bytes(data)
    entry, n_kernel = rd.take("<II")
    if entry >= len(idmap):
        raise MastFormatError("entrypoint out of range")
    entry = idmap[entry]
    if n_kernel > MAX_ADVICE_ENTRIES:
        raise MastFormatError("kernel budget exceeded")
    kernel = tuple(rd.word() for _ in range(n_kernel))
    if rd.off != len(rd.data):
        raise MastFormatError("trailing bytes")
    return Program(forest=forest, entrypoint=entry, kernel_digests=kernel)
