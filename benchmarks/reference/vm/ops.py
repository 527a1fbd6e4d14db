"""VM operations: the Miden instruction set's primitive op layer.

Behavioral spec: core/src/operations/mod.rs — each operation is a 7-bit
opcode (`Operation::OP_BITS = 7`, mod.rs:602), some carrying one immediate
field element (Push, Assert, MpVerify, U32assert2, Emit carry immediates in
the current reference). Opcode values are protocol constants (they are
hashed into MAST digests), reproduced from core/src/operations/mod.rs:29-129.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import gl

OP_BITS = 7  # core/src/operations/mod.rs:602
GROUP_SIZE = 9  # ops per group (basic_block_node/mod.rs:33)
BATCH_SIZE = 8  # groups per batch (basic_block_node/mod.rs:36)

# opcode table (core/src/operations/mod.rs:29-129)
OPCODES = {
    # system
    "NOOP": 0b0000_0000,
    "EQZ": 0b0000_0001,
    "NEG": 0b0000_0010,
    "INV": 0b0000_0011,
    "INCR": 0b0000_0100,
    "NOT": 0b0000_0101,
    "MLOAD": 0b0000_0111,
    "SWAP": 0b0000_1000,
    "CALLER": 0b0000_1001,
    "MOVUP2": 0b0000_1010,
    "MOVDN2": 0b0000_1011,
    "MOVUP3": 0b0000_1100,
    "MOVDN3": 0b0000_1101,
    "ADVPOPW": 0b0000_1110,
    "EXPACC": 0b0000_1111,
    "MOVUP4": 0b0001_0000,
    "MOVDN4": 0b0001_0001,
    "MOVUP5": 0b0001_0010,
    "MOVDN5": 0b0001_0011,
    "MOVUP6": 0b0001_0100,
    "MOVDN6": 0b0001_0101,
    "MOVUP7": 0b0001_0110,
    "MOVDN7": 0b0001_0111,
    "SWAPW": 0b0001_1000,
    "EXT2MUL": 0b0001_1001,
    "MOVUP8": 0b0001_1010,
    "MOVDN8": 0b0001_1011,
    "SWAPW2": 0b0001_1100,
    "SWAPW3": 0b0001_1101,
    "SWAPDW": 0b0001_1110,
    "EMIT": 0b0001_1111,
    "ASSERT": 0b0010_0000,
    "EQ": 0b0010_0001,
    "ADD": 0b0010_0010,
    "MUL": 0b0010_0011,
    "AND": 0b0010_0100,
    "OR": 0b0010_0101,
    "U32AND": 0b0010_0110,
    "U32XOR": 0b0010_0111,
    "FRIE2F4": 0b0010_1000,
    "DROP": 0b0010_1001,
    "CSWAP": 0b0010_1010,
    "CSWAPW": 0b0010_1011,
    "MLOADW": 0b0010_1100,
    "MSTORE": 0b0010_1101,
    "MSTOREW": 0b0010_1110,
    "PAD": 0b0011_0000,
    "DUP0": 0b0011_0001,
    "DUP1": 0b0011_0010,
    "DUP2": 0b0011_0011,
    "DUP3": 0b0011_0100,
    "DUP4": 0b0011_0101,
    "DUP5": 0b0011_0110,
    "DUP6": 0b0011_0111,
    "DUP7": 0b0011_1000,
    "DUP9": 0b0011_1001,
    "DUP11": 0b0011_1010,
    "DUP13": 0b0011_1011,
    "DUP15": 0b0011_1100,
    "ADVPOP": 0b0011_1101,
    "SDEPTH": 0b0011_1110,
    "CLK": 0b0011_1111,
    # u32 ops occupy even slots (their shifted flag degree needs bit 0 = 0)
    "U32ADD": 0b0100_0000,
    "U32SUB": 0b0100_0010,
    "U32MUL": 0b0100_0100,
    "U32DIV": 0b0100_0110,
    "U32SPLIT": 0b0100_1000,
    "U32ASSERT2": 0b0100_1010,
    "U32ADD3": 0b0100_1100,
    "U32MADD": 0b0100_1110,
    "HPERM": 0b0101_0000,
    "MPVERIFY": 0b0101_0001,
    "PIPE": 0b0101_0010,
    "MSTREAM": 0b0101_0011,
    "SPLIT": 0b0101_0100,
    "LOOP": 0b0101_0101,
    "SPAN": 0b0101_0110,
    "JOIN": 0b0101_0111,
    "DYN": 0b0101_1000,
    "HORNERBASE": 0b0101_1001,
    "HORNEREXT": 0b0101_1010,
    "PUSH": 0b0101_1011,
    "DYNCALL": 0b0101_1100,
    "EVALCIRCUIT": 0b0101_1101,
    "LOGDEFERRED": 0b0101_1110,
    "MRUPDATE": 0b0110_0000,
    "CRYPTOSTREAM": 0b0110_0100,
    "SYSCALL": 0b0110_1000,
    "CALL": 0b0110_1100,
    "END": 0b0111_0000,
    "REPEAT": 0b0111_0100,
    "RESPAN": 0b0111_1000,
    "HALT": 0b0111_1100,
}

# Only PUSH's immediate enters the op-group stream (Operation::imm_value,
# core/src/operations/mod.rs:618). Assert/U32assert2/MpVerify error codes are
# metadata fingerprinted separately (basic_block_node/mod.rs:692) and do NOT
# affect batching.
_IMM_OPS = frozenset({"PUSH"})
_ERR_CODE_OPS = frozenset({"ASSERT", "U32ASSERT2", "MPVERIFY"})


@dataclass(frozen=True)
class Op:
    """One VM operation; PUSH carries a batching immediate, assert-class ops
    carry an error code that stays out of the group stream."""

    name: str
    imm: int | None = None
    err_code: int = 0

    def __post_init__(self):
        if self.name not in OPCODES:
            raise ValueError(f"unknown operation {self.name}")
        if (self.imm is not None) != (self.name in _IMM_OPS):
            raise ValueError(f"{self.name}: immediate mismatch")
        if self.imm is not None:
            object.__setattr__(self, "imm", self.imm % gl.P)
        if self.err_code and self.name not in _ERR_CODE_OPS:
            raise ValueError(f"{self.name}: does not carry an error code")

    @property
    def op_code(self) -> int:
        return OPCODES[self.name]

    @property
    def imm_value(self) -> int | None:
        return self.imm

    def __repr__(self) -> str:
        return self.name.lower() if self.imm is None else f"{self.name.lower()}({self.imm})"


NOOP = Op("NOOP")


def push(value: int) -> Op:
    return Op("PUSH", value % gl.P)


def assert_op(err_code: int = 0) -> Op:
    return Op("ASSERT", err_code=err_code)
