"""Core execution-trace column layout (51 columns).

Mirrors the reference layout exactly (air/src/trace/mod.rs:23-27,
air/src/constraints/{system,decoder,stack,range}/columns.rs):

    system (6) | decoder (24) | stack (19) | range (2)

All indices are into the core main-trace matrix of shape (n, 51).
"""

from __future__ import annotations

# -- system (air/src/constraints/system/columns.rs) -------------------------
CLK = 0
CTX = 1
FN_HASH = (2, 3, 4, 5)  # digest of the currently executing function

SYS_WIDTH = 6

# -- decoder (air/src/constraints/decoder/columns.rs) -----------------------
ADDR = 6  # block address (hasher controller row pointer)
OP_BITS = tuple(range(7, 14))  # b0..b6, b0 = LSB of the opcode
HASHER = tuple(range(14, 22))  # h0..h7 (block hashing / op decoding / helpers)
IN_SPAN = 22
GROUP_COUNT = 23
OP_INDEX = 24
BATCH_FLAGS = (25, 26, 27)  # c0, c1, c2
EXTRA = (28, 29)  # e0 = b6*(1-b5)*b4, e1 = b6*b5

DECODER_WIDTH = 24

# user-op helper registers live in hasher_state[2..8]
USER_OP_HELPERS = HASHER[2:8]
# END-row flags live in hasher_state[4..8]
END_IS_LOOP_BODY = HASHER[4]
END_IS_LOOP = HASHER[5]
END_IS_CALL = HASHER[6]
END_IS_SYSCALL = HASHER[7]

# -- stack (air/src/constraints/stack/columns.rs) ---------------------------
STACK_TOP = tuple(range(30, 46))  # s0..s15
B0 = 46  # stack depth
B1 = 47  # overflow table: clk of last overflowed element (0 = empty)
H0 = 48  # 1/(b0-16) when b0 != 16, else 0

STACK_WIDTH = 19

# -- range checker (air/src/constraints/range/columns.rs) -------------------
RC_MULT = 49  # multiplicity of the value on this row
RC_VALUE = 50  # 16-bit value being range checked

RANGE_WIDTH = 2

CORE_WIDTH = SYS_WIDTH + DECODER_WIDTH + STACK_WIDTH + RANGE_WIDTH
assert CORE_WIDTH == 51

MIN_STACK_DEPTH = 16
MIN_TRACE_LEN = 64

# op-batch flag encodings by group count (docs decoder/index.md §batch flags)
BATCH_FLAGS_BY_COUNT = {8: (1, 0, 0), 4: (0, 1, 0), 2: (0, 0, 1), 1: (0, 1, 1)}
