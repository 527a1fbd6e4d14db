"""Chiplets trace: stacked hasher + bitwise + memory + ACE + kernel-ROM
chiplet regions (24 columns).

Mirrors the reference chiplets module structure (docs chiplets/index.md):
regions are stacked top-down, identified by a monotone selector prefix,
padded with all-ones selectors; `chip_clk` counts rows from 1. The stack
order is:

    hasher (s0=0) | bitwise (s0=1, s1=0) | memory (s0=1, s1=1, s2=0)
    | ACE (1,1,1,0) | kernel ROM (1,1,1,1,0) | padding (all-ones)

and any region may be empty (the selector monotonicity constraints allow
s-prefixes to skip straight past an absent region).

Column layout (width 24):
  0..4   s0..s4 top-level selectors (overlaying payload per region)
  bitwise payload (cols 2..14):  s, a, b, a0..a3, b0..b3, zp, z
  memory payload  (cols 3..17):  rw, ew, ctx, word_addr, idx0, idx1,
                                 clk, v0..v3, d0, d1, t, f_scw
  hasher payload  (cols 1..20, 22, 23): hs0, hs1, bnd, state[12],
                                 perm_id, m, idx, dir, mro, mrn, mrid
  21     chip_clk (row index + 1)

Specs: docs/src/design/chiplets/{memory,bitwise}.md; operation labels
from chiplets/index.md (§operation labels).
"""

from __future__ import annotations

import numpy as np

from ..field import gl

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


def _pair(state, bnd_in, bnd_out, ret_state=0, merkle=0,
          idx_in=0, dir_in=0, idx_out=0, dir_out=0, mro=0, mrn=0, mrid=0):
    return dict(
        state=state, bnd_in=bnd_in, bnd_out=bnd_out, ret_state=ret_state,
        merkle=merkle, idx_in=idx_in, dir_in=dir_in, idx_out=idx_out,
        dir_out=dir_out, mro=mro, mrn=mrn, mrid=mrid,
    )


def _merkle_pairs(value, siblings, index, mro=0, mrn=0, mrid=0):
    """One compression pair per level; the digest routes into rate0/rate1
    of the next input by the next direction bit."""
    from ..hash import poseidon2_host as hp

    pairs = []
    cur = [v % P for v in value]
    idx = index
    d = len(siblings)
    for lvl, sib in enumerate(siblings):
        bit = idx & 1
        rate = [*sib, *cur] if bit else [*cur, *sib]
        state = [*rate, 0, 0, 0, 0]
        nidx = idx >> 1
        pairs.append(_pair(
            state,
            bnd_in=1 if lvl == 0 else 0,
            bnd_out=1 if lvl == d - 1 else 0,
            merkle=1,
            idx_in=idx,
            dir_in=bit,
            idx_out=nidx,
            dir_out=(nidx & 1) if lvl < d - 1 else 0,
            mro=mro, mrn=mrn, mrid=mrid,
        ))
        cur = hp.permute(state)[:4]
        idx = nidx
    assert idx == 0, "merkle path shorter than index"
    return pairs


def _hasher_pairs(requests: list):
    """Expand hasher requests into permutation pair records, chained for
    sequential hashes and Merkle paths."""
    from ..hash import poseidon2_host as hp

    pairs = []
    for req in requests:
        kind = req[0]
        if kind == "control_block":
            _, addr, h1, h2, domain = req
            state = [*h1, *h2, 0, domain % P, 0, 0]
            pairs.append(_pair(state, 1, 1))
        elif kind == "basic_block":
            _, addr, batches = req
            cap = [0, 0, 0, 0]
            for i, batch in enumerate(batches):
                state = [*(v % P for v in batch), *cap]
                last = i == len(batches) - 1
                pairs.append(_pair(state, 1 if i == 0 else 0, 1 if last else 0))
                cap = hp.permute(state)[8:12]
        elif kind == "permute":
            _, addr, state = req
            pairs.append(_pair([v % P for v in state], 1, 1, ret_state=1))
        elif kind == "merkle_root":
            _, addr, value, siblings, index = req
            pairs.extend(_merkle_pairs(value, siblings, index))
        elif kind == "update_merkle_root":
            # two legs with the same siblings/index; the sibling-table bus
            # (keyed by mrid = the old leg's start address) forces the legs
            # to absorb identical siblings (docs hasher.md §sibling-table)
            _, addr, old_value, new_value, siblings, index = req
            pairs.extend(
                _merkle_pairs(old_value, siblings, index, mro=1, mrid=addr)
            )
            pairs.extend(
                _merkle_pairs(new_value, siblings, index, mrn=1, mrid=addr)
            )
        else:
            raise NotImplementedError(
                f"hasher request kind {kind!r} not provable yet"
            )
    return pairs


def _hasher_rows_native(requests: list):
    """Vectorized controller-row builder for the linear-hash request kinds
    (control_block / basic_block / permute): permutation chains run in C
    (native/trace_gen.c p2_chain_basic_block), row scatter and cycle dedup
    in numpy. Returns (rows, cycle_states (u,12), counts (u,)) or None when
    a request kind needs the general path (Merkle legs)."""
    from ..native import trace_gen_lib, u64ptr

    lib = trace_gen_lib()
    states_parts, outs_parts, bnd_in_parts, bnd_out_parts, ret_parts = (
        [], [], [], [], []
    )
    for req in requests:
        kind = req[0]
        if kind == "control_block":
            _, addr, h1, h2, domain = req
            st = np.asarray([[*h1, *h2, 0, domain % P, 0, 0]], dtype=np.uint64)
            out = st.copy()
            lib.p2_permute_batch(u64ptr(out), 1)
            states_parts.append(st)
            outs_parts.append(out)
            bnd_in_parts.append([1]); bnd_out_parts.append([1]); ret_parts.append([0])
        elif kind == "basic_block":
            _, addr, batches = req
            k = len(batches)
            b = np.asarray(batches, dtype=np.uint64).reshape(k, 8)
            st = np.zeros((k, 12), dtype=np.uint64)
            out = np.zeros((k, 12), dtype=np.uint64)
            lib.p2_chain_basic_block(u64ptr(np.ascontiguousarray(b)), k, u64ptr(st), u64ptr(out))
            states_parts.append(st)
            outs_parts.append(out)
            bi = np.zeros(k, dtype=np.uint64); bi[0] = 1
            bo = np.zeros(k, dtype=np.uint64); bo[-1] = 1
            bnd_in_parts.append(bi); bnd_out_parts.append(bo)
            ret_parts.append(np.zeros(k, dtype=np.uint64))
        elif kind == "permute":
            _, addr, state = req
            st = np.asarray([[v % P for v in state]], dtype=np.uint64)
            out = st.copy()
            lib.p2_permute_batch(u64ptr(out), 1)
            states_parts.append(st)
            outs_parts.append(out)
            bnd_in_parts.append([1]); bnd_out_parts.append([1]); ret_parts.append([1])
        else:
            return None  # Merkle request kinds: general path
    if not states_parts:
        return np.zeros((0, CHIPLETS_WIDTH), dtype=np.uint64), np.zeros((0, 12), dtype=np.uint64), np.zeros(0, dtype=np.uint64)
    states = np.concatenate(states_parts)
    outs = np.concatenate(outs_parts)
    bnd_in = np.concatenate([np.asarray(x, dtype=np.uint64) for x in bnd_in_parts])
    bnd_out = np.concatenate([np.asarray(x, dtype=np.uint64) for x in bnd_out_parts])
    ret = np.concatenate([np.asarray(x, dtype=np.uint64) for x in ret_parts])

    # dedup cycles in FIRST-OCCURRENCE order (matches the dict-based path)
    uniq, first_idx, inverse, counts = np.unique(
        states, axis=0, return_index=True, return_inverse=True, return_counts=True
    )
    order = np.argsort(first_idx)
    rank = np.empty(len(uniq), dtype=np.uint64)
    rank[order] = np.arange(len(uniq), dtype=np.uint64)
    pid = rank[inverse]
    cycle_states = uniq[order]
    cycle_counts = counts[order].astype(np.uint64)

    k = states.shape[0]
    n = 2 * k
    padded = -n % 8
    rows = np.zeros((n + padded, CHIPLETS_WIDTH), dtype=np.uint64)
    rin = rows[0:n:2]
    rout = rows[1:n:2]
    rin[:, H_HS0] = 1
    rin[:, H_BND] = bnd_in
    rout[:, H_HS1] = ret
    rout[:, H_BND] = bnd_out
    for i in range(12):
        rin[:, H_STATE[i]] = states[:, i]
        rout[:, H_STATE[i]] = outs[:, i]
    rin[:, H_PERM] = pid
    rout[:, H_PERM] = pid
    rows[n:, H_HS0] = 1
    rows[n:, H_HS1] = 1
    return rows, cycle_states, cycle_counts


def build_hasher_rows(requests: list):
    """Controller rows (2 per permutation pair, padded to 8-row alignment)
    plus the deduplicated permutation cycles for Poseidon2PermutationAir.

    Returns (rows, cycles) where cycles is a list of
    (input_state, multiplicity)."""
    from ..hash import poseidon2_host as hp

    fast = _hasher_rows_native(requests)
    if fast is not None:
        rows, cycle_states, cycle_counts = fast
        return rows, (cycle_states, cycle_counts)

    pairs = _hasher_pairs(requests)
    n = 2 * len(pairs)
    padded = -n % 8
    rows = np.zeros((n + padded, CHIPLETS_WIDTH), dtype=np.uint64)

    perm_ids: dict[tuple, int] = {}
    counts: dict[tuple, int] = {}
    cycles: list[tuple[list[int], int]] = []
    for k, pr in enumerate(pairs):
        state = pr["state"]
        key = tuple(state)
        pid = perm_ids.get(key)
        if pid is None:
            pid = len(cycles)
            perm_ids[key] = pid
            cycles.append((list(state), 0))
        counts[key] = counts.get(key, 0) + 1
        out = hp.permute(state)
        rin = rows[2 * k]
        rin[H_HS0] = 1
        rin[H_BND] = pr["bnd_in"]
        for i in range(12):
            rin[H_STATE[i]] = state[i]
        rin[H_PERM] = pid
        rin[H_HS2] = pr["merkle"]
        rin[H_IDX] = pr["idx_in"]
        rin[H_DIR] = pr["dir_in"]
        rin[H_MRO] = pr["mro"]
        rin[H_MRN] = pr["mrn"]
        rin[H_MRID] = pr["mrid"]
        rout = rows[2 * k + 1]
        rout[H_HS1] = pr["ret_state"]
        rout[H_BND] = pr["bnd_out"]
        for i in range(12):
            rout[H_STATE[i]] = out[i]
        rout[H_PERM] = pid
        rout[H_HS2] = pr["merkle"]
        rout[H_IDX] = pr["idx_out"]
        rout[H_DIR] = pr["dir_out"]
        rout[H_MRO] = pr["mro"]
        rout[H_MRN] = pr["mrn"]
        rout[H_MRID] = pr["mrid"]
    cycles = [(st, counts[tuple(st)]) for st, _ in cycles]
    # controller padding rows: (hs0, hs1) = (1, 1)
    rows[n:, H_HS0] = 1
    rows[n:, H_HS1] = 1
    return rows, cycles


def _poseidon_trace_native(cycle_states: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Vectorized Poseidon2PermutationAir trace: packed 16-row schedules
    computed in C, scattered with numpy."""
    from ..native import trace_gen_lib, u64ptr

    lib = trace_gen_lib()
    u = cycle_states.shape[0]
    k = 1 << u.bit_length()  # ≥ one zero-multiplicity padding cycle
    states = np.zeros((k, 12), dtype=np.uint64)
    states[:u] = cycle_states  # padding cycles use the zero state
    rows = np.zeros((k, 16, 12), dtype=np.uint64)
    wits = np.zeros((k, 16, 3), dtype=np.uint64)
    lib.p2_packed_rows(u64ptr(np.ascontiguousarray(states)), k, u64ptr(rows), u64ptr(wits))
    m = np.zeros((16 * k, POSEIDON_WIDTH), dtype=np.uint64)
    m[:, P_WITNESS[0] : P_WITNESS[2] + 1] = wits.reshape(16 * k, 3)
    m[:, P_STATE[0] : P_STATE[11] + 1] = rows.reshape(16 * k, 12)
    m[:, P_PERM] = np.repeat(np.arange(k, dtype=np.uint64), 16)
    mults = np.zeros(k, dtype=np.uint64)
    mults[:u] = counts
    m[0::16, P_WITNESS[0]] = mults
    m[15::16, P_WITNESS[0]] = mults
    return m


def build_poseidon_trace(cycles) -> np.ndarray:
    """Poseidon2 permutation trace: one 16-row packed cycle per unique
    input state; multiplicity in witness[0] of rows 0 and 15; padding
    cycles use the zero state with multiplicity 0."""
    from ..hash import poseidon2_host as hp

    if isinstance(cycles, tuple):  # native path: (states (u,12), counts)
        return _poseidon_trace_native(*cycles)

    # at least one zero-multiplicity padding cycle at the end: the final
    # trace row's wiring fraction never enters the accumulator (transition
    # window), so the last cycle must be padding
    k = 1 << len(cycles).bit_length()
    m = np.zeros((16 * k, POSEIDON_WIDTH), dtype=np.uint64)
    for cid in range(k):
        state, mult = cycles[cid] if cid < len(cycles) else ([0] * 12, 0)
        states, wits = hp.permute_packed_rows(state)
        for r in range(16):
            row = m[16 * cid + r]
            for i in range(3):
                row[P_WITNESS[i]] = wits[r][i]
            for i in range(12):
                row[P_STATE[i]] = states[r][i]
            row[P_PERM] = cid
        m[16 * cid, P_WITNESS[0]] = mult
        m[16 * cid + 15, P_WITNESS[0]] = mult
    return m


def build_bitwise_rows(bitwise_log: list) -> np.ndarray:
    """8 rows per operation: 4-bit limbs of a and b injected MSB-first,
    result aggregated in z (docs bitwise.md)."""
    rows = np.zeros((8 * len(bitwise_log), CHIPLETS_WIDTH), dtype=np.uint64)
    for k, (is_xor, a, b, z) in enumerate(bitwise_log):
        zacc = 0
        for r in range(8):
            shift = 4 * (7 - r)
            a_hi = a >> shift
            b_hi = b >> shift
            a_bits = [(a_hi >> i) & 1 for i in range(4)]
            b_bits = [(b_hi >> i) & 1 for i in range(4)]
            nib = (
                sum(
                    (1 << i)
                    * (
                        a_bits[i] ^ b_bits[i]
                        if is_xor
                        else a_bits[i] & b_bits[i]
                    )
                    for i in range(4)
                )
            )
            row = rows[8 * k + r]
            row[S0] = 1
            row[S1] = 0
            row[BW_S] = is_xor
            row[BW_A] = a_hi
            row[BW_B] = b_hi
            for i in range(4):
                row[BW_A_BITS[i]] = a_bits[i]
                row[BW_B_BITS[i]] = b_bits[i]
            row[BW_ZP] = zacc
            zacc = zacc * 16 + nib
            row[BW_Z] = zacc
        assert zacc == z
    return rows


def build_memory_rows(mem_log: list) -> tuple[np.ndarray, list[int]]:
    """Memory chiplet rows sorted by (ctx, word_addr, clk) with the word
    state carried forward; returns (rows, d-limb range-check requests)."""
    # normalize: (ctx, word_addr, clk, rw, ew, idx, values)
    accesses = []
    for kind, ctx, addr, clk, values in mem_log:
        word_addr = addr - addr % 4
        idx = addr % 4
        rw = 1 if kind in ("re", "rw") else 0
        ew = 1 if kind in ("rw", "ww") else 0
        accesses.append((ctx, word_addr, clk, rw, ew, 0 if ew else idx, values))
    accesses.sort(key=lambda x: (x[0], x[1], x[2], x[3]))

    rows = np.zeros((len(accesses), CHIPLETS_WIDTH), dtype=np.uint64)
    range_requests: list[int] = []
    word = [0, 0, 0, 0]
    prev = None
    for r, (ctx, wa, clk, rw, ew, idx, values) in enumerate(accesses):
        same = prev is not None and prev[0] == ctx and prev[1] == wa
        if not same:
            word = [0, 0, 0, 0]
        if ew:
            if rw:
                assert values == word, (
                    f"memory read-word mismatch at ctx={ctx} addr={wa}: "
                    f"{values} vs {word}"
                )
            else:
                word = list(v % P for v in values)
        else:
            if rw:
                assert values[0] == word[idx], (
                    f"memory read mismatch at ctx={ctx} addr={wa + idx}"
                )
            else:
                word[idx] = values[0] % P
        row = rows[r]
        row[S0] = 1
        row[S1] = 1
        row[S2] = 0
        row[M_RW] = rw
        row[M_EW] = ew
        row[M_CTX] = ctx
        row[M_ADDR] = wa
        row[M_IDX0] = idx & 1
        row[M_IDX1] = idx >> 1
        row[M_CLK] = clk
        for i in range(4):
            row[M_V[i]] = word[i]
        if prev is not None:
            pctx, pwa, pclk = prev
            if ctx != pctx:
                delta = ctx - pctx
                t = gl.inv(delta)
            elif wa != pwa:
                delta = wa - pwa
                t = gl.inv(delta)
            else:
                delta = clk - pclk
                t = gl.inv(delta) if delta else 0
            row[M_T] = t
            row[M_FSCW] = 1 if same else 0
        else:
            # first row: delta fixed to 1 (prev clk treated as clk − 1,
            # reference trace/chiplets/memory/mod.rs:260)
            delta = 1
        assert 0 <= delta < (1 << 32), "memory delta out of u32"
        row[M_D0] = delta & 0xFFFF
        row[M_D1] = delta >> 16
        # word-index decomposition: proves addr is a valid 32-bit address
        # (reference memory/mod.rs:286-295)
        word_index = wa // 4
        w0 = word_index & 0xFFFF
        w1 = word_index >> 16
        row[M_W0] = w0
        row[M_W1] = w1
        range_requests.extend((delta & 0xFFFF, delta >> 16, w0, w1, 4 * w1))
        prev = (ctx, wa, clk)
    return rows, range_requests


def build_ace_rows(ace_log: list) -> np.ndarray:
    """ACE chiplet sections (docs chiplets/ace.md): per evaluation, R READ
    rows (one word = two nodes each) then N EVAL rows (one decoded gate
    each); node ids descend from R·2 + N − 1 to 0; multiplicities count
    each node's fan-out so the wire bus balances."""
    from ..field import gl as _gl

    sections = []
    for ctx, ptr, clk, n_read_rows, n_eval, var_words, instrs in ace_log:
        total = 2 * n_read_rows + n_eval
        values: dict[int, tuple] = {}
        mult: dict[int, int] = {i: 0 for i in range(total)}
        decoded = []
        nid = total - 1
        for w in var_words:
            values[nid] = (w[0], w[1])
            values[nid - 1] = (w[2], w[3])
            nid -= 2
        for ins in instrs:
            id_l = ins & ACE_MAX_ID
            id_r = (ins >> 30) & ACE_MAX_ID
            opv = ins >> 60
            mult[id_l] += 1
            mult[id_r] += 1
            vl, vr = values[id_l], values[id_r]
            v = (_gl.ext_sub, _gl.ext_mul, _gl.ext_add)[opv](vl, vr)
            values[nid] = v
            decoded.append((opv, id_l, id_r))
            nid -= 1
        rows = np.zeros((n_read_rows + n_eval, CHIPLETS_WIDTH), dtype=np.uint64)
        rows[:, S0:S2 + 1] = 1
        rows[:, S3] = 0
        nid = total - 1
        p = ptr
        for r in range(n_read_rows):
            row = rows[r]
            row[A_SSTART] = 1 if r == 0 else 0
            row[A_SBLOCK] = 0
            row[A_CTX], row[A_PTR], row[A_CLK] = ctx, p, clk
            row[A_ID0] = nid
            row[A_V0[0]], row[A_V0[1]] = values[nid]
            row[A_ID1] = nid - 1
            row[A_V1[0]], row[A_V1[1]] = values[nid - 1]
            row[A_ID2] = n_eval - 1
            row[A_V2[1]] = mult[nid - 1]  # m1
            row[A_M0] = mult[nid]
            nid -= 2
            p += 4
        for k in range(n_eval):
            row = rows[n_read_rows + k]
            opv, id_l, id_r = decoded[k]
            row[A_SBLOCK] = 1
            row[A_CTX], row[A_PTR], row[A_CLK] = ctx, p, clk
            row[A_OP] = (opv - 1) % P  # signed op
            row[A_ID0] = nid
            row[A_V0[0]], row[A_V0[1]] = values[nid]
            row[A_ID1] = id_l
            row[A_V1[0]], row[A_V1[1]] = values[id_l]
            row[A_ID2] = id_r
            row[A_V2[0]], row[A_V2[1]] = values[id_r]
            row[A_M0] = mult[nid]
            nid -= 1
            p += 1
        sections.append(rows)
    if not sections:
        return np.zeros((0, CHIPLETS_WIDTH), dtype=np.uint64)
    return np.concatenate(sections, axis=0)


def build_kernel_rows(kernel_digests, kernel_log: list) -> np.ndarray:
    """One row per declared kernel procedure with its syscall multiplicity
    (docs kernel_rom.md — all shape is enforced by the LogUp buses)."""
    counts: dict[tuple, int] = {}
    for digest in kernel_log:
        counts[tuple(digest)] = counts.get(tuple(digest), 0) + 1
    rows = np.zeros((len(kernel_digests), CHIPLETS_WIDTH), dtype=np.uint64)
    for r, digest in enumerate(kernel_digests):
        key = tuple(digest)
        rows[r, S0:S3 + 1] = 1
        rows[r, S4] = 0
        rows[r, K_MULT] = counts.pop(key, 0)
        for i in range(4):
            rows[r, K_ROOT[i]] = digest[i]
    assert not counts, f"syscalls to undeclared kernel procs: {list(counts)}"
    return rows


def build_chiplets_trace(
    hasher_requests: list,
    bitwise_log: list,
    mem_log: list,
    kernel_digests=(),
    kernel_log=(),
    ace_log=(),
) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Stack the chiplet regions (hasher | bitwise | memory | ACE |
    kernel ROM | padding) into a power-of-two matrix; returns (chiplets,
    poseidon, d-limb range-check requests)."""
    hrows, cycles = build_hasher_rows(hasher_requests)
    bw = build_bitwise_rows(bitwise_log)
    mem, range_requests = build_memory_rows(mem_log)
    ace = build_ace_rows(list(ace_log))
    krom = build_kernel_rows(kernel_digests, list(kernel_log))
    used = (
        hrows.shape[0] + bw.shape[0] + mem.shape[0] + ace.shape[0]
        + krom.shape[0]
    )
    height = 1 << max(3, used.bit_length())
    if height == used:
        height <<= 1  # the last row must be padding
    m = np.zeros((height, CHIPLETS_WIDTH), dtype=np.uint64)
    o = hrows.shape[0]
    m[:o] = hrows
    m[o : o + bw.shape[0]] = bw
    o += bw.shape[0]
    m[o : o + mem.shape[0]] = mem
    o += mem.shape[0]
    m[o : o + ace.shape[0]] = ace
    o += ace.shape[0]
    m[o:used] = krom
    # padding region: all selectors 1
    m[used:, S0:S4 + 1] = 1
    m[:, CHIP_CLK] = np.arange(1, height + 1, dtype=np.uint64)
    poseidon = build_poseidon_trace(cycles)
    return m, poseidon, range_requests
