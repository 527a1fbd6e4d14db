"""Chiplets trace layout: the column indices and operation labels the
chiplets and Poseidon2 AIRs read (a copy of the constants of the port's
``vm/chiplets.py``; the trace builders there are the prover's, not copied).
"""

from __future__ import annotations

from .. import gl

P = gl.P

CHIPLETS_WIDTH = 24

S0, S1, S2, S3, S4 = 0, 1, 2, 3, 4

# bitwise payload (valid when s0=1, s1=0)
BW_S = 2
BW_A = 3
BW_B = 4
BW_A_BITS = (5, 6, 7, 8)
BW_B_BITS = (9, 10, 11, 12)
BW_ZP = 13
BW_Z = 14

# memory payload (valid when s0=1, s1=1, s2=0)
M_RW = 3  # 1 = read, 0 = write
M_EW = 4  # 1 = word access, 0 = element access
M_CTX = 5
M_ADDR = 6  # word address (multiple of 4)
M_IDX0 = 7
M_IDX1 = 8
M_CLK = 9
M_V = (10, 11, 12, 13)
M_D0 = 14
M_D1 = 15
M_T = 16
M_FSCW = 17
M_W0 = 18  # word_index & 0xFFFF (addr = 4·w0 + 2^18·w1)
M_W1 = 19  # word_index >> 16 (< 2^14, enforced by the 4·w1 range check)

# kernel ROM payload (region s0..s3 = 1, s4 = 0): one row per declared
# kernel procedure (docs chiplets/kernel_rom.md)
K_MULT = 5  # syscall multiplicity (may be 0)
K_ROOT = (6, 7, 8, 9)  # procedure digest

# ACE payload (region s0 s1 s2 = 1, s3 = 0): 16 columns per
# docs chiplets/ace.md §trace-layout; READ rows reuse A_ID2 for n_eval
# (= N - 1), A_V21 for m1; the EVAL op column stores the signed op
A_SSTART = 4
A_SBLOCK = 5  # 0 = READ, 1 = EVAL
A_CTX = 6
A_PTR = 7
A_CLK = 8
A_OP = 9  # signed: -1 sub | 0 mul | +1 add
A_ID0 = 10
A_V0 = (11, 12)
A_ID1 = 13
A_V1 = (14, 15)
A_ID2 = 16  # n_eval on READ rows
A_V2 = (17, 18)  # (unused, m1) on READ rows
A_M0 = 19
ACE_MAX_ID = (1 << 30) - 1

CHIP_CLK = 21

# hasher controller payload (region s0 = 0)
# row kinds: input (hs0=1, hs1=0) | output (hs0=0, hs1=ret_state) |
# padding (hs0=1, hs1=1)
H_HS0 = 1
H_HS1 = 2
H_BND = 3  # boundary: sponge start (inputs) / final output (outputs)
H_STATE = tuple(range(4, 16))  # rate0[4] | rate1[4] | capacity[4]
H_PERM = 16  # permutation cycle id (links to Poseidon2PermutationAir)
H_HS2 = 17  # Merkle-mode flag (path verification rows)
H_IDX = 18  # remaining node index (inputs) / shifted index (outputs)
H_DIR = 19  # direction bit: this level's (inputs) / next level's (outputs)
H_MRO = 20  # MRUPDATE old-path leg flag (implies Merkle mode)
H_MRN = 22  # MRUPDATE new-path leg flag (implies Merkle mode)
H_MRID = 23  # update id shared by both legs (old leg's start address)

# Poseidon2 permutation trace layout (16 columns, 16-row cycles)
P_WITNESS = (0, 1, 2)
P_STATE = tuple(range(3, 15))
P_PERM = 15
POSEIDON_WIDTH = 16

# operation labels (chiplets/index.md §operation labels)
OP_HASH_START = 3  # LINEAR_HASH: full-state sponge initialization
OP_HASH_ABSORB = 35  # LINEAR_HASH + 32: rate-only continuation
OP_HASH_RETURN = 1  # RETURN_HASH: digest (rate0)
OP_HASH_RETSTATE = 9  # RETURN_STATE: full state (HPERM)
OP_HASH_MPVERIFY = 11  # MP_VERIFY: Merkle path verification start
OP_HASH_MRUPDATE_OLD = 13  # MR_UPDATE old-path start (11 + 2·mro)
OP_HASH_MRUPDATE_NEW = 15  # MR_UPDATE new-path start (11 + 4·mrn)
OP_BITWISE_AND = 2
OP_BITWISE_XOR = 6
OP_MEM_WRITE_ELEMENT = 4
OP_MEM_READ_ELEMENT = 12
OP_MEM_WRITE_WORD = 20
OP_MEM_READ_WORD = 28
OP_KERNEL_PROC_CALL = 16
OP_KERNEL_PROC_INIT = 48
OP_ACE_INIT = 8  # 1 + 0b0111 (chiplets/index.md §operation labels)

