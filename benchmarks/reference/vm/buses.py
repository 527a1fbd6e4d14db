"""LogUp buses for the core VM AIR: the decoder's virtual tables, the
stack overflow table, and the range-checker bus.

Structure follows the reference's LogUp layout (air/src/lookup/
constraint.rs): aux column 0 is the running-sum accumulator, columns 1+
hold per-row fraction values (Nᵢ/Dᵢ); constraints check
``Dᵢ·auxᵢ − Nᵢ = 0`` per fraction column and
``acc' = acc + Σᵢ auxᵢ`` for the accumulator. Mutually exclusive
interaction sets share a column through flag-muxed (V, U) pairs, keeping
the constraint degree ≤ 9.

Message encoding: ``D = α + (bus+1)·β^W + Σ β^k·elem_k`` with W = 16
(bus_prefix convention of air/src/trace/mod.rs `bus_message`).

Tables (docs/src/design/decoder/constraints.md, stack/index.md,
range.md):
  - block stack  (blk, prnt, is_loop, ctx, b0, b1, fn_hash[4])
  - block hash   (parent, hash[4], is_first_child, is_loop_body)
    — seeded with (0, program_hash, 0, 0) via the first-row accumulator
  - op group     (batch_id, group_pos, group_value)
  - overflow     (addr, value, prev_addr)
  - range        (value), multiplicity-weighted responses
"""

from __future__ import annotations

from . import layout as L

W = 16  # message width bound: bus_prefix[i] = α + (i+1)·β^W

BUS_BLOCK_STACK = 0
BUS_BLOCK_HASH = 1
BUS_OP_GROUP = 2
BUS_OVERFLOW = 3
BUS_RANGE = 4
# reserved for the chiplet AIRs:
BUS_CHIPLET = 5
BUS_KERNEL = 6
BUS_WIRING_IN = 7  # hasher controller ↔ Poseidon2 permutation link (inputs)
BUS_WIRING_OUT = 8  # same, output states
BUS_SIBLING = 9  # MRUPDATE sibling table (hasher-internal, sums to zero)
BUS_ACE_WIRE = 10  # ACE evaluation-graph wiring (sums to zero per circuit)
BUS_DEFERRED = 11  # LOGDEFERRED root chain (terminals are public boundary)

NUM_FRACTION_COLUMNS = 4  # block_stack | block_hash+op_group | overflow | range
AUX_WIDTH = 1 + NUM_FRACTION_COLUMNS


class Challenges:
    """β-power and bus-prefix tables over Folder expressions."""

    def __init__(self, f):
        alpha = f.rand(0)
        beta = f.rand(1)
        pows = [f.const(1), beta]
        for _ in range(W - 1):
            pows.append(pows[-1] * beta)
        self.beta = pows  # β^0 .. β^W
        self.alpha = alpha

    def msg(self, bus: int, elems):
        d = self.alpha + self.beta[W] * (bus + 1)
        for k, e in enumerate(elems):
            if isinstance(e, int) and e == 0:
                continue
            d = d + self.beta[k] * e
        return d


def _batch(one, fracs):
    """Sum of fractions m/d as a (V, U) pair (no gating)."""
    V, U = one * 0, one
    for m, d in fracs:
        V = V * d + U * m
        U = U * d
    return V, U


def mux(one, branches):
    """Combine mutually exclusive flag-gated fraction batches into a single
    (V, U) pair: U = Σ φᵢ·Ubᵢ + (1 − Σφᵢ), V = Σ φᵢ·Vbᵢ."""
    V = one * 0
    U = one
    for flag, fracs in branches:
        Vb, Ub = _batch(one, fracs)
        V = V + flag * Vb
        U = U + flag * (Ub - 1)
    return V, U


def seq(a, b):
    """Sequential composition of two (V, U) fraction sums."""
    Va, Ua = a
    Vb, Ub = b
    return Va * Ub + Vb * Ua, Ua * Ub


def core_bus_columns(f, fl):
    """(V, U) pairs for the 4 core fraction columns; shared by the
    constraint path (any backend) and the numeric aux builder."""
    ch = Challenges(f)
    flg = fl.flags
    one = f.const(1)

    s = [f.main(c) for c in L.STACK_TOP]
    t = [f.main(c, 1) for c in L.STACK_TOP]
    h = [f.main(c) for c in L.HASHER]
    hn = [f.main(c, 1) for c in L.HASHER]
    a = f.main(L.ADDR)
    an = f.main(L.ADDR, 1)
    sp = f.main(L.IN_SPAN)
    gc = f.main(L.GROUP_COUNT)
    gcn = f.main(L.GROUP_COUNT, 1)
    clk = f.main(L.CLK)
    ctx = f.main(L.CTX)
    ctxn = f.main(L.CTX, 1)
    fn = [f.main(c) for c in L.FN_HASH]
    fnn = [f.main(c, 1) for c in L.FN_HASH]
    b0 = f.main(L.B0)
    b0n = f.main(L.B0, 1)
    b1 = f.main(L.B1)
    b1n = f.main(L.B1, 1)
    sh0 = f.main(L.H0)

    # ---- column 1: block stack table ----------------------------------
    h6_or_h7 = h[6] + h[7]
    end_elems = [
        a, an, h[5],
        h6_or_h7 * ctxn, h6_or_h7 * b0n, h6_or_h7 * b1n,
        *[h6_or_h7 * fnn[i] for i in range(4)],
    ]
    block_stack = mux(one, [
        (flg["JOIN"] + flg["SPLIT"] + flg["SPAN"],
         [(1, ch.msg(BUS_BLOCK_STACK, [an, a]))]),
        (flg["LOOP"], [(1, ch.msg(BUS_BLOCK_STACK, [an, a, 1]))]),
        (flg["RESPAN"], [
            (-1, ch.msg(BUS_BLOCK_STACK, [a, hn[1]])),
            (1, ch.msg(BUS_BLOCK_STACK, [an, hn[1]])),
        ]),
        (flg["DYN"], [(1, ch.msg(BUS_BLOCK_STACK, [an, a]))]),
        (flg["DYNCALL"], [(1, ch.msg(
            BUS_BLOCK_STACK, [an, a, 0, ctx, h[4], h[5], *fn]))]),
        (flg["CALL"] + flg["SYSCALL"], [(1, ch.msg(
            BUS_BLOCK_STACK, [an, a, 0, ctx, b0, b1, *fn]))]),
        (flg["END"], [(-1, ch.msg(BUS_BLOCK_STACK, end_elems))]),
    ])

    # ---- column 2: block hash table + op group table ------------------
    # disjoint row sets: control-flow opcodes vs SPAN/RESPAN/in-span rows
    is_first = 1 - fl.next_ctrl["ANY"]  # next op not END/REPEAT/RESPAN/HALT
    split_child = [s[0] * h[i] + (1 - s[0]) * h[i + 4] for i in range(4)]
    c0 = f.main(L.BATCH_FLAGS[0])
    c1 = f.main(L.BATCH_FLAGS[1])
    c2 = f.main(L.BATCH_FLAGS[2])
    fg8 = c0
    fg4 = (1 - c0) * c1 * (1 - c2)
    fg2 = (1 - c0) * (1 - c1) * c2
    op_next = sum(
        (f.main(L.OP_BITS[i], 1) * (1 << i) for i in range(1, 7)),
        f.main(L.OP_BITS[0], 1),
    )
    group_removed = hn[0] * 128 + op_next + fl.imm * (t[0] - (hn[0] * 128 + op_next))
    f_dg = sp * (gc - gcn)
    block_hash_op_group = mux(one, [
        (flg["JOIN"], [
            (1, ch.msg(BUS_BLOCK_HASH, [an, h[0], h[1], h[2], h[3], 1, 0])),
            (1, ch.msg(BUS_BLOCK_HASH, [an, h[4], h[5], h[6], h[7], 0, 0])),
        ]),
        (flg["SPLIT"], [(1, ch.msg(BUS_BLOCK_HASH, [an, *split_child, 0, 0]))]),
        (flg["LOOP"] + flg["REPEAT"],
         [(1, ch.msg(BUS_BLOCK_HASH, [an, h[0], h[1], h[2], h[3], 0, 1]))]),
        (flg["DYN"] + flg["DYNCALL"] + flg["CALL"] + flg["SYSCALL"],
         [(1, ch.msg(BUS_BLOCK_HASH, [an, h[0], h[1], h[2], h[3], 0, 0]))]),
        (flg["END"], [(-1, ch.msg(
            BUS_BLOCK_HASH, [an, h[0], h[1], h[2], h[3], is_first, h[4]]))]),
        (fg8, [(1, ch.msg(BUS_OP_GROUP, [an, gc - i, h[i]])) for i in range(1, 8)]),
        (fg4, [(1, ch.msg(BUS_OP_GROUP, [an, gc - i, h[i]])) for i in range(1, 4)]),
        (fg2, [(1, ch.msg(BUS_OP_GROUP, [an, gc - 1, h[1]]))]),
        (f_dg, [(-1, ch.msg(BUS_OP_GROUP, [a, gc, group_removed]))]),
    ])

    # ---- column 3: stack overflow table + deferred-root chain ---------
    # LOGDEFERRED threads the rolling deferred root: remove the previous
    # root (helpers 1..5), insert the new one (next-row stack[0:4]); the
    # zero/final terminals are public boundary terms in eval_external
    # (air lookup/miden_air.rs:60-62)
    f_ov = (b0 - 16) * sh0
    uh = [f.main(c) for c in L.USER_OP_HELPERS]
    overflow = mux(one, [
        (fl.shift_right, [(1, ch.msg(BUS_OVERFLOW, [clk, s[15], b1]))]),
        (fl.shift_left * f_ov, [(-1, ch.msg(BUS_OVERFLOW, [b1, t[15], b1n]))]),
        (flg["DYNCALL"] * f_ov, [(-1, ch.msg(BUS_OVERFLOW, [b1, t[15], h[5]]))]),
        (flg["LOGDEFERRED"], [
            (-1, ch.msg(BUS_DEFERRED, [uh[1], uh[2], uh[3], uh[4]])),
            (1, ch.msg(BUS_DEFERRED, [t[0], t[1], t[2], t[3]])),
        ]),
    ])

    # ---- column 4: range checker bus ----------------------------------
    response = (
        f.main(L.RC_MULT),
        ch.msg(BUS_RANGE, [f.main(L.RC_VALUE)]),
    )
    requests = mux(one, [
        (fl.u32_rc, [(-1, ch.msg(BUS_RANGE, [uh[i]])) for i in range(4)]),
    ])
    range_col = seq(_batch(one, [response]), requests)

    # ---- column 5: chiplet-bus requests (memory / bitwise) ------------
    # message shapes match the chiplet responders (chiplets_air.py):
    # memory [label, ctx, elem_addr, clk, values...] with labels
    # 4/12/20/28 (chiplets/index.md §operation labels), bitwise
    # [label, a, b, z] with labels 2/6.
    def mem_msg(label, addr_e, vals):
        return ch.msg(BUS_CHIPLET, [label, ctx, addr_e, clk, *vals])

    dyn_read = ch.msg(
        BUS_CHIPLET, [28, ctx, s[0], clk, h[0], h[1], h[2], h[3]]
    )
    fmp_write = ch.msg(
        # FMP_ADDR = u32::MAX - 1 (core/src/lib.rs:121)
        BUS_CHIPLET, [4, ctxn, (1 << 32) - 2, clk, 1 << 31]
    )

    # hasher requests (docs decoder/index.md §program-block-hashing):
    # block starts hash at controller address a' (the new block id), the
    # END row reads the digest at a + 1; control blocks carry the opcode
    # in capacity lane 1 (merge_in_domain convention).
    from .ops import OPCODES

    op_cur = sum(
        (f.main(L.OP_BITS[i]) * (1 << i) for i in range(1, 7)),
        f.main(L.OP_BITS[0]),
    )

    def hash_start(rate, domain):
        return ch.msg(
            BUS_CHIPLET,
            [3, an, *rate, 0, domain, 0, 0],
        )

    start_join_split = hash_start(h[:8], op_cur)
    start_one_word = hash_start([h[0], h[1], h[2], h[3], 0, 0, 0, 0], op_cur)
    start_zero = hash_start([0] * 8, op_cur)
    start_span = ch.msg(BUS_CHIPLET, [3, an, *h[:8]])
    absorb_respan = ch.msg(BUS_CHIPLET, [35, an, *h[:8]])
    end_read = ch.msg(BUS_CHIPLET, [1, a + 1, h[0], h[1], h[2], h[3]])
    hperm_start = ch.msg(BUS_CHIPLET, [3, uh[0], *s[:12]])
    hperm_ret = ch.msg(BUS_CHIPLET, [9, uh[0] + 1, *t[:12]])
    # MPVERIFY: [V, depth, index, R, ...] — leaf + index enter at the
    # controller address in helper[0]; the root returns 2·depth − 1 rows
    # later (crypto_ops.md mpverify; hasher.md §merkle-path-verification)
    mpv_start = ch.msg(BUS_CHIPLET, [11, uh[0], s[0], s[1], s[2], s[3], s[5]])
    mpv_ret = ch.msg(
        BUS_CHIPLET,
        [1, uh[0] + 2 * s[4] - 1, s[6], s[7], s[8], s[9]],
    )
    # MRUPDATE: [V_old, d, i, R_old, V_new, ...] → [R_new, ...] — the old
    # leg starts at uh[0] with mrid = uh[0]; the new leg follows at
    # uh[0] + 2d; each returns its root 2d − 1 rows after its start
    mru_old_start = ch.msg(
        BUS_CHIPLET, [13, uh[0], s[0], s[1], s[2], s[3], s[5], uh[0]]
    )
    mru_old_ret = ch.msg(
        BUS_CHIPLET, [1, uh[0] + 2 * s[4] - 1, s[6], s[7], s[8], s[9]]
    )
    mru_new_start = ch.msg(
        BUS_CHIPLET,
        [15, uh[0] + 2 * s[4], s[10], s[11], s[12], s[13], s[5], uh[0]],
    )
    mru_new_ret = ch.msg(
        BUS_CHIPLET, [1, uh[0] + 4 * s[4] - 1, t[0], t[1], t[2], t[3]]
    )
    kernel_call = ch.msg(BUS_CHIPLET, [16, h[0], h[1], h[2], h[3]])
    # LOGDEFERRED: permute [prev_root (helpers 1..5), stmt (s[4:8]),
    # Tag::AND capacity]; full output state lands on t[0:12] like HPERM
    logdef_start = ch.msg(
        BUS_CHIPLET,
        [3, uh[0], uh[1], uh[2], uh[3], uh[4],
         s[4], s[5], s[6], s[7], 1, 0, 0],
    )
    logdef_ret = ch.msg(BUS_CHIPLET, [9, uh[0] + 1, *t[:12]])

    chiplet_req = mux(one, [
        (flg["MLOAD"], [(-1, mem_msg(12, s[0], [t[0]]))]),
        (flg["MSTORE"], [(-1, mem_msg(4, s[0], [t[0]]))]),
        (flg["MLOADW"], [(-1, mem_msg(28, s[0], t[0:4]))]),
        (flg["MSTOREW"], [(-1, mem_msg(20, s[0], t[0:4]))]),
        (flg["MSTREAM"], [
            (-1, mem_msg(28, s[12], t[0:4])),
            (-1, mem_msg(28, s[12] + 4, t[4:8])),
        ]),
        (flg["PIPE"], [
            (-1, mem_msg(20, s[12], t[0:4])),
            (-1, mem_msg(20, s[12] + 4, t[4:8])),
        ]),
        (flg["U32AND"], [(-1, ch.msg(BUS_CHIPLET, [2, s[0], s[1], t[0]]))]),
        (flg["U32XOR"], [(-1, ch.msg(BUS_CHIPLET, [6, s[0], s[1], t[0]]))]),
        (flg["JOIN"] + flg["SPLIT"], [(-1, start_join_split)]),
        (flg["LOOP"], [(-1, start_one_word)]),
        (flg["SYSCALL"], [(-1, start_one_word), (-1, kernel_call)]),
        (flg["CALL"], [(-1, start_one_word), (-1, fmp_write)]),
        (flg["SPAN"], [(-1, start_span)]),
        (flg["RESPAN"], [(-1, absorb_respan)]),
        (flg["END"], [(-1, end_read)]),
        (flg["HPERM"], [(-1, hperm_start), (-1, hperm_ret)]),
        # α reads (crypto_ops.md §HORNERBASE/§HORNEREXT): two element
        # reads at s13/s13+1 (values h0, h1) / one word read at s13
        (flg["HORNERBASE"], [
            (-1, mem_msg(12, s[13], [uh[0]])),
            (-1, mem_msg(12, s[13] + 1, [uh[1]])),
        ]),
        (flg["HORNEREXT"], [(-1, mem_msg(28, s[13], uh[0:4]))]),
        # ACE circuit-evaluation delegation (chiplets/ace.md §chiplet-bus)
        (flg["EVALCIRCUIT"], [
            (-1, ch.msg(BUS_CHIPLET, [8, ctx, s[0], clk, s[1], s[2]])),
        ]),
        (flg["LOGDEFERRED"], [(-1, logdef_start), (-1, logdef_ret)]),
        # plaintext reads (ciphertext − rate) and ciphertext writes
        # (crypto_ops.md §CRYPTOSTREAM)
        (flg["CRYPTOSTREAM"], [
            (-1, mem_msg(28, s[12], [t[i] - s[i] for i in range(4)])),
            (-1, mem_msg(28, s[12] + 4, [t[i] - s[i] for i in range(4, 8)])),
            (-1, mem_msg(20, s[13], t[0:4])),
            (-1, mem_msg(20, s[13] + 4, t[4:8])),
        ]),
        (flg["MPVERIFY"], [(-1, mpv_start), (-1, mpv_ret)]),
        (flg["MRUPDATE"], [
            (-1, mru_old_start), (-1, mru_old_ret),
            (-1, mru_new_start), (-1, mru_new_ret),
        ]),
        (flg["DYN"], [(-1, dyn_read), (-1, start_zero)]),
        (flg["DYNCALL"], [(-1, dyn_read), (-1, start_zero), (-1, fmp_write)]),
    ])

    return [
        block_stack, block_hash_op_group, overflow, range_col, chiplet_req
    ], ch


def seed_denominator(f):
    """Block-hash-table seed row (0, program_hash, 0, 0): the accumulator
    starts at 1/d_seed so a balanced execution ends at 0."""
    ch = Challenges(f)
    ph = [f.public(32 + i) for i in range(4)]
    return ch.msg(BUS_BLOCK_HASH, [0, *ph, 0, 0])
