"""Chiplets AIR: stacked bitwise + memory chiplet constraints and their
chiplet-bus / range-bus interactions.

Specs: docs/src/design/chiplets/{index,bitwise,memory}.md. The selector
prefix is monotone (regions can be empty); bitwise runs in 8-row cycles
driven by periodic columns k0/k1; memory rows are sorted by
(ctx, word_addr, clk) with 16-bit delta limbs range-checked through the
cross-AIR range bus.

Aux layout (3 EF columns): [accumulator, chiplet-bus responses,
range-bus requests]. The final accumulator value is committed
(num_aux_values = 1) and balanced against the core AIR's committed
final through ``VmMultiAir.eval_external``.
"""

from __future__ import annotations

from ...stark.air import Air
from .. import chiplets as C
from .buses import (
    BUS_ACE_WIRE,
    BUS_CHIPLET,
    BUS_RANGE,
    BUS_SIBLING,
    BUS_WIRING_IN,
    BUS_WIRING_OUT,
    Challenges,
    mux,
)

P2_16 = 1 << 16


def chiplet_bus_columns(f):
    """(V, U) pairs for the chiplet-bus response column and the range-bus
    request column; shared by the constraint path and the numeric aux
    builder."""
    ch = Challenges(f)
    one = f.const(1)
    s0 = f.main(C.S0)
    s1 = f.main(C.S1)
    s2 = f.main(C.S2)
    s2n = f.main(C.S2, 1)
    fb = s0 * (1 - s1)
    f_mem = s0 * s1 * (1 - s2)
    f_mem_nl = s0 * s1 * (1 - s2n)
    k1 = f.periodic(1)
    rw = f.main(C.M_RW)
    ew = f.main(C.M_EW)
    ctx = f.main(C.M_CTX)
    addr = f.main(C.M_ADDR)
    idx0 = f.main(C.M_IDX0)
    idx1 = f.main(C.M_IDX1)
    clk = f.main(C.M_CLK)
    v = [f.main(c) for c in C.M_V]
    d0n = f.main(C.M_D0, 1)
    d1n = f.main(C.M_D1, 1)
    fidx = [
        (1 - idx1) * (1 - idx0),
        (1 - idx1) * idx0,
        idx1 * (1 - idx0),
        idx1 * idx0,
    ]
    # memory response (docs memory.md §memory-row-value): label
    # 4 + 8·rw + 16·ew, element address addr + 2·idx1 + idx0, value lanes
    # muxed between the word and the selected element
    label = 4 + rw * 8 + ew * 16
    elem_addr = addr + idx1 * 2 + idx0
    e4 = ew * v[0] + (1 - ew) * sum(
        (fidx[i] * v[i] for i in range(1, 4)), fidx[0] * v[0]
    )
    mem_msg = ch.msg(
        BUS_CHIPLET,
        [label, ctx, elem_addr, clk, e4, ew * v[1], ew * v[2], ew * v[3]],
    )
    # bitwise response at the cycle's final row (m = 1 - k1)
    a = f.main(C.BW_A)
    b = f.main(C.BW_B)
    z = f.main(C.BW_Z)
    bs = f.main(C.BW_S)
    bw_msg = ch.msg(BUS_CHIPLET, [2 + bs * 4, a, b, z])
    # hasher controller responses: sponge starts/continuations on input
    # rows, digest / full-state returns on output rows, addressed by
    # chip_clk (docs chiplets/hasher.md §lookup-buses)
    fh = 1 - s0
    hs0 = f.main(C.H_HS0)
    hs1 = f.main(C.H_HS1)
    bnd = f.main(C.H_BND)
    hstate = [f.main(c) for c in C.H_STATE]
    cc = f.main(C.CHIP_CLK)
    hm = f.main(C.H_HS2)
    hidx = f.main(C.H_IDX)
    hdir = f.main(C.H_DIR)
    is_input = hs0 * (1 - hs1)
    is_output = 1 - hs0
    start_msg = ch.msg(BUS_CHIPLET, [C.OP_HASH_START, cc, *hstate])
    absorb_msg = ch.msg(BUS_CHIPLET, [C.OP_HASH_ABSORB, cc, *hstate[:8]])
    ret_msg = ch.msg(BUS_CHIPLET, [C.OP_HASH_RETURN, cc, *hstate[:4]])
    retstate_msg = ch.msg(BUS_CHIPLET, [C.OP_HASH_RETSTATE, cc, *hstate])
    # MP_VERIFY / MR_UPDATE_{OLD,NEW} start: the leaf sits in the rate
    # half selected by the direction bit; the label encodes the leg
    # (docs chiplets/hasher.md §merkle-path-verification)
    mro = f.main(C.H_MRO)
    mrn = f.main(C.H_MRN)
    mrid = f.main(C.H_MRID)
    leaf = [
        hstate[i] + hdir * (hstate[4 + i] - hstate[i]) for i in range(4)
    ]
    mpv_msg = ch.msg(
        BUS_CHIPLET,
        [C.OP_HASH_MPVERIFY + 2 * mro + 4 * mrn, cc, *leaf, hidx, mrid],
    )
    # ACE section-start response (docs chiplets/ace.md §chiplet-bus):
    # (ACE_INIT, ctx, ptr, clk, n_read, n_eval) with
    # n_read = id0 - stored_n_eval and n_eval = stored + 1
    s3 = f.main(C.S3)
    f_ace = s0 * s1 * s2 * (1 - s3)
    a_ss = f.main(C.A_SSTART)
    a_ctx = f.main(C.A_CTX)
    a_ptr = f.main(C.A_PTR)
    a_clk = f.main(C.A_CLK)
    a_id0 = f.main(C.A_ID0)
    a_id2 = f.main(C.A_ID2)
    ace_msg = ch.msg(
        BUS_CHIPLET,
        [C.OP_ACE_INIT, a_ctx, a_ptr, a_clk, a_id0 - a_id2, a_id2 + 1],
    )
    resp = mux(one, [
        (f_mem, [(1, mem_msg)]),
        (fb * (1 - k1), [(1, bw_msg)]),
        (fh * is_input * bnd * (1 - hm), [(1, start_msg)]),
        (fh * is_input * bnd * hm, [(1, mpv_msg)]),
        (fh * is_input * (1 - bnd) * (1 - hm), [(1, absorb_msg)]),
        (fh * is_output * (1 - hs1) * bnd, [(1, ret_msg)]),
        (fh * is_output * hs1, [(1, retstate_msg)]),
        (f_ace * a_ss, [(1, ace_msg)]),
    ])
    # sibling table (docs hasher.md §sibling-table-constraints): old-leg
    # input rows insert (mrid, idx, dir, sibling); new-leg rows remove the
    # same entry — balancing forces both legs onto identical siblings
    sib = [
        hstate[4 + i] + hdir * (hstate[i] - hstate[4 + i]) for i in range(4)
    ]
    sib_msg = ch.msg(BUS_SIBLING, [mrid, hidx, hdir, *sib])
    sibling = mux(one, [
        (fh * is_input * mro, [(1, sib_msg)]),
        (fh * is_input * mrn, [(-1, sib_msg)]),
    ])
    # range-bus requests: every memory row checks its own delta limbs plus
    # the word-index decomposition (w0, w1, 4·w1 — proves addr < 2^32;
    # reference trace/chiplets/memory/mod.rs:284-295)
    d0 = f.main(C.M_D0)
    d1 = f.main(C.M_D1)
    w0c = f.main(C.M_W0)
    w1c = f.main(C.M_W1)
    range_req = mux(one, [
        (f_mem, [
            (-1, ch.msg(BUS_RANGE, [d0])),
            (-1, ch.msg(BUS_RANGE, [d1])),
            (-1, ch.msg(BUS_RANGE, [w0c])),
            (-1, ch.msg(BUS_RANGE, [w1c])),
            (-1, ch.msg(BUS_RANGE, [4 * w1c])),
        ]),
    ])
    # kernel ROM: one INIT remove (balanced by the verifier's public
    # boundary term over the declared kernel digests) and m CALL adds
    # (balanced by SYSCALL requests) per row (docs kernel_rom.md)
    s3 = f.main(C.S3)
    s4 = f.main(C.S4)
    f_krom = s0 * s1 * s2 * s3 * (1 - s4)
    kmult = f.main(C.K_MULT)
    kroot = [f.main(c) for c in C.K_ROOT]
    v_init = ch.msg(BUS_CHIPLET, [C.OP_KERNEL_PROC_INIT, *kroot])
    v_call = ch.msg(BUS_CHIPLET, [C.OP_KERNEL_PROC_CALL, *kroot])
    krom = mux(one, [
        (f_krom, [(-1, v_init), (kmult, v_call)]),
    ])
    # perm-link wiring: every controller pair inserts its input and output
    # states keyed by perm_id; Poseidon2PermutationAir removes them with
    # cycle multiplicities
    perm = f.main(C.H_PERM)
    wiring = mux(one, [
        (fh * is_input, [(1, ch.msg(BUS_WIRING_IN, [perm, *hstate]))]),
        (fh * is_output, [(1, ch.msg(BUS_WIRING_OUT, [perm, *hstate]))]),
    ])
    # ---- ACE wire bus + memory requests (docs chiplets/ace.md) --------
    a_sb = f.main(C.A_SBLOCK)
    a_op = f.main(C.A_OP)
    a_v0 = [f.main(c) for c in C.A_V0]
    a_id1 = f.main(C.A_ID1)
    a_v1 = [f.main(c) for c in C.A_V1]
    a_v2 = [f.main(c) for c in C.A_V2]
    a_m0 = f.main(C.A_M0)
    # wire bus: READ rows insert nodes (id0, id1) with fan-out counts
    # (m0, m1); EVAL rows insert id0 and consume (id1, id2)
    w0 = ch.msg(BUS_ACE_WIRE, [a_ctx, a_clk, a_id0, *a_v0])
    w1 = ch.msg(BUS_ACE_WIRE, [a_ctx, a_clk, a_id1, *a_v1])
    w2 = ch.msg(BUS_ACE_WIRE, [a_ctx, a_clk, a_id2, *a_v2])
    e1 = (1 - a_sb) * a_v2[1] - a_sb  # m1 sits in the A_V2[1] column
    wire = mux(one, [
        (f_ace, [(a_m0, w0), (e1, w1), (-a_sb, w2)]),
    ])
    # memory requests: one word (two nodes) per READ row, one packed
    # instruction element per EVAL row
    instr = a_id1 + (1 << 30) * a_id2 + (1 << 60) * (a_op + 1)
    ace_read_msg = ch.msg(
        BUS_CHIPLET,
        [C.OP_MEM_READ_WORD, a_ctx, a_ptr, a_clk, *a_v0, *a_v1],
    )
    ace_instr_msg = ch.msg(
        BUS_CHIPLET, [C.OP_MEM_READ_ELEMENT, a_ctx, a_ptr, a_clk, instr]
    )
    ace_mem = mux(one, [
        (f_ace * (1 - a_sb), [(-1, ace_read_msg)]),
        (f_ace * a_sb, [(-1, ace_instr_msg)]),
    ])
    return resp, range_req, wiring, krom, sibling, wire, ace_mem


class ChipletsVmAir(Air):
    width = C.CHIPLETS_WIDTH
    # acc | responses | range req | wiring | krom | siblings | ace wire |
    # ace memory requests
    aux_width = 8
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 40  # shared statement publics (unused here)
    periodic_columns = (
        (1, 0, 0, 0, 0, 0, 0, 0),  # k0: first row of each 8-row cycle
        (1, 1, 1, 1, 1, 1, 1, 0),  # k1: all but the last row of each cycle
        (1, 0),  # p2: controller input rows sit at even region offsets
    )

    def eval(self, f) -> None:  # noqa: C901
        fam = {"zero": [], "trans": [], "first": [], "last": []}

        def A(kind, e, label):
            fam[kind].append((e, label))

        s0 = f.main(C.S0)
        s1 = f.main(C.S1)
        s2 = f.main(C.S2)
        s3 = f.main(C.S3)
        s4 = f.main(C.S4)
        s0n = f.main(C.S0, 1)
        s1n = f.main(C.S1, 1)
        s2n = f.main(C.S2, 1)
        s3n = f.main(C.S3, 1)

        # ---- selector prefix: binary + monotone 0→1 -----------------------
        prefix = f.const(1)
        for i, (s, sn) in enumerate(
            ((s0, s0n), (s1, s1n), (s2, s2n), (s3, s3n), (s4, None))
        ):
            A("zero", prefix * (s * s - s), f"sel{i}/binary")
            if sn is not None:
                A("trans", prefix * s * (sn - s), f"sel{i}/monotone")
            prefix = prefix * s

        # ---- chip_clk row counter -----------------------------------------
        cc = f.main(C.CHIP_CLK)
        A("first", cc - 1, "chip_clk/first")
        A("trans", f.main(C.CHIP_CLK, 1) - cc - 1, "chip_clk/incr")

        # ---- bitwise chiplet (fb = s0·(1-s1)) -----------------------------
        fb = s0 * (1 - s1)
        k0 = f.periodic(0)
        k1 = f.periodic(1)
        bs = f.main(C.BW_S)
        a = f.main(C.BW_A)
        b = f.main(C.BW_B)
        an = f.main(C.BW_A, 1)
        bn = f.main(C.BW_B, 1)
        abits = [f.main(c) for c in C.BW_A_BITS]
        bbits = [f.main(c) for c in C.BW_B_BITS]
        abitsn = [f.main(c, 1) for c in C.BW_A_BITS]
        bbitsn = [f.main(c, 1) for c in C.BW_B_BITS]
        zp = f.main(C.BW_ZP)
        z = f.main(C.BW_Z)
        zpn = f.main(C.BW_ZP, 1)

        A("zero", fb * (bs * bs - bs), "bw/s_binary")
        A("trans", fb * k1 * (f.main(C.BW_S, 1) - bs), "bw/s_stable")
        for i in range(4):
            A("zero", fb * (abits[i] * abits[i] - abits[i]), f"bw/a{i}_bin")
            A("zero", fb * (bbits[i] * bbits[i] - bbits[i]), f"bw/b{i}_bin")
        agg_a = sum((abits[i] * (1 << i) for i in range(1, 4)), abits[0])
        agg_b = sum((bbits[i] * (1 << i) for i in range(1, 4)), bbits[0])
        agg_an = sum((abitsn[i] * (1 << i) for i in range(1, 4)), abitsn[0])
        agg_bn = sum((bbitsn[i] * (1 << i) for i in range(1, 4)), bbitsn[0])
        A("zero", fb * k0 * (a - agg_a), "bw/a_init")
        A("zero", fb * k0 * (b - agg_b), "bw/b_init")
        A("trans", fb * k1 * (an - (a * 16 + agg_an)), "bw/a_shift")
        A("trans", fb * k1 * (bn - (b * 16 + agg_bn)), "bw/b_shift")
        A("zero", fb * k0 * zp, "bw/zp_init")
        A("trans", fb * k1 * (z - zpn), "bw/z_chain")
        v_and = sum(
            (abits[i] * bbits[i] * (1 << i) for i in range(1, 4)),
            abits[0] * bbits[0],
        )
        v_xor = sum(
            ((abits[i] + bbits[i] - 2 * abits[i] * bbits[i]) * (1 << i)
             for i in range(1, 4)),
            abits[0] + bbits[0] - 2 * abits[0] * bbits[0],
        )
        A("zero", fb * (z - (zp * 16 + v_and + bs * (v_xor - v_and))), "bw/agg")

        # ---- memory chiplet ----------------------------------------------
        f_mem = s0 * s1 * (1 - s2)
        f_mem_nl = s0 * s1 * (1 - s2n)
        # first memory row: previous row is bitwise (s0=1, s1=0) or hasher
        # (s0=0) and the next row is memory. Region monotonicity lets each
        # variant stay degree 4: after a bitwise row only s0=1 regions can
        # follow, so s0n is implied; after a hasher row s0n must be checked.
        f_mem_fr_bw = s0 * (1 - s1) * s1n * (1 - s2n)
        f_mem_fr_h = (1 - s0) * s0n * s1n * (1 - s2n)
        f_mem_fr = f_mem_fr_bw + f_mem_fr_h
        rw = f.main(C.M_RW)
        ew = f.main(C.M_EW)
        ctx = f.main(C.M_CTX)
        addr = f.main(C.M_ADDR)
        idx0 = f.main(C.M_IDX0)
        idx1 = f.main(C.M_IDX1)
        clk = f.main(C.M_CLK)
        v = [f.main(c) for c in C.M_V]
        rwn = f.main(C.M_RW, 1)
        ewn = f.main(C.M_EW, 1)
        ctxn = f.main(C.M_CTX, 1)
        addrn = f.main(C.M_ADDR, 1)
        idx0n = f.main(C.M_IDX0, 1)
        idx1n = f.main(C.M_IDX1, 1)
        clkn = f.main(C.M_CLK, 1)
        vn = [f.main(c, 1) for c in C.M_V]
        d0n = f.main(C.M_D0, 1)
        d1n = f.main(C.M_D1, 1)
        tn = f.main(C.M_T, 1)
        fscwn = f.main(C.M_FSCW, 1)

        dctx = ctxn - ctx
        da = addrn - addr
        dclk = clkn - clk
        n0 = dctx * tn
        n1 = da * tn

        A("trans", f_mem_nl * (n0 * n0 - n0), "mem/n0_bin")
        A("trans", f_mem_nl * (1 - n0) * dctx, "mem/ctx_same")
        A("trans", f_mem_nl * (1 - n0) * (n1 * n1 - n1), "mem/n1_bin")
        A("trans", f_mem_nl * (1 - n0) * (1 - n1) * da, "mem/addr_same")
        for name, col in (("rw", rw), ("ew", ew), ("idx0", idx0), ("idx1", idx1)):
            A("zero", f_mem * (col * col - col), f"mem/{name}_bin")
        A("zero", f_mem * ew * idx0, "mem/word_idx0")
        A("zero", f_mem * ew * idx1, "mem/word_idx1")
        A(
            "trans",
            f_mem_nl
            * (
                n0 * dctx
                + (1 - n0) * (n1 * da + (1 - n1) * dclk)
                - (d1n * P2_16 + d0n)
            ),
            "mem/delta_limbs",
        )
        A(
            "trans",
            f_mem_nl * fscwn * (1 - dclk * tn) * ((1 - rw) + (1 - rwn)),
            "mem/same_clk_reads",
        )
        # first memory row: delta fixed to (1, 0) — the row's own d-limbs
        # enter the range bus (reference memory/mod.rs:260 prev_clk = clk−1)
        d0c = f.main(C.M_D0)
        d1c = f.main(C.M_D1)
        A("trans", f_mem_fr * (d0n - 1), "mem/first_d0")
        A("trans", f_mem_fr * d1n, "mem/first_d1")
        A("first", f_mem * (d0c - 1), "mem/row0_d0")
        A("first", f_mem * d1c, "mem/row0_d1")
        # word-index decomposition: addr = 4·w0 + 2^18·w1 with w0, w1, 4·w1
        # range-checked ⇒ addr is a valid word-aligned 32-bit address
        w0c = f.main(C.M_W0)
        w1c = f.main(C.M_W1)
        A("zero", f_mem * (addr - 4 * w0c - (1 << 18) * w1c), "mem/addr_decomp")
        A(
            "trans",
            f_mem_nl * (fscwn - (1 - n0) * (1 - n1)),
            "mem/fscw",
        )

        fidx_n = [
            (1 - idx1n) * (1 - idx0n),
            (1 - idx1n) * idx0n,
            idx1n * (1 - idx0n),
            idx1n * idx0n,
        ]
        for i in range(4):
            ci = rwn + (1 - rwn) * (1 - ewn) * (1 - fidx_n[i])
            A("trans", f_mem_fr * ci * vn[i], f"mem/first_v{i}")
            A(
                "trans",
                f_mem_nl * ci * (fscwn * (vn[i] - v[i]) + (1 - fscwn) * vn[i]),
                f"mem/copy_v{i}",
            )
        # when the memory region starts at trace row 0 (empty bitwise region)
        fidx = [
            (1 - idx1) * (1 - idx0),
            (1 - idx1) * idx0,
            idx1 * (1 - idx0),
            idx1 * idx0,
        ]
        for i in range(4):
            ci0 = rw + (1 - rw) * (1 - ew) * (1 - fidx[i])
            A("first", f_mem * ci0 * v[i], f"mem/row0_v{i}")

        # ---- hasher controller (fh = 1 - s0) ------------------------------
        # docs chiplets/hasher.md §AIR obligations: row-kind booleanity,
        # input/output pairing, padding stability, perm-id pair equality,
        # sponge capacity chaining across continuations
        fh = 1 - s0
        p2 = f.periodic(2)
        hs0 = f.main(C.H_HS0)
        hs1 = f.main(C.H_HS1)
        hbnd = f.main(C.H_BND)
        hs0n = f.main(C.H_HS0, 1)
        hs1n = f.main(C.H_HS1, 1)
        hperm = f.main(C.H_PERM)
        hpermn = f.main(C.H_PERM, 1)
        is_pad = hs0 * hs1
        is_input = hs0 * (1 - hs1)
        is_output = 1 - hs0
        is_pad_n = hs0n * hs1n
        for name, col in (("hs0", hs0), ("hs1", hs1), ("bnd", hbnd)):
            A("zero", fh * (col * col - col), f"hash/{name}_bin")
        A("zero", fh * (1 - is_pad) * (p2 - is_input), "hash/pairing")
        A("trans", fh * is_input * s0n, "hash/input_has_output")
        A("trans", fh * is_input * (hpermn - hperm), "hash/perm_pair")
        A("trans", fh * is_pad * (1 - s0n) * (1 - is_pad_n), "hash/pad_stable")
        cont = fh * is_output * (1 - hbnd) * (1 - hs1)
        hm = f.main(C.H_HS2)
        hmn = f.main(C.H_HS2, 1)
        for i in range(8, 12):
            A(
                "trans",
                cont * (1 - hm)
                * (f.main(C.H_STATE[i], 1) - f.main(C.H_STATE[i])),
                f"hash/chain_cap{i}",
            )
        A("trans", cont * (is_pad_n + s0n), "hash/chain_next_input")

        # ---- Merkle-path rows (m = 1) -------------------------------------
        # docs chiplets/hasher.md §merkle-path-verification: each level is a
        # 2-to-1 compression (zero capacity); the index halves per level with
        # its low bit selecting which rate half carries the running node, and
        # the digest chains into the dir-selected rate half of the next level
        hidx = f.main(C.H_IDX)
        hidxn = f.main(C.H_IDX, 1)
        hdir = f.main(C.H_DIR)
        hdirn = f.main(C.H_DIR, 1)
        A("zero", fh * (hm * hm - hm), "hash/m_bin")
        A("zero", fh * (hdir * hdir - hdir), "hash/dir_bin")
        A("trans", fh * is_input * (hmn - hm), "hash/m_pair")
        A(
            "trans",
            fh * is_input * hm * (hidx - 2 * hidxn - hdir),
            "hash/idx_halve",
        )
        for i in range(8, 12):
            A("zero", fh * is_input * hm * f.main(C.H_STATE[i]),
              f"hash/merkle_cap{i}")
        A("zero", fh * is_output * hm * hbnd * hidx, "hash/merkle_idx_final")
        mcont = cont * hm
        A("trans", mcont * (hmn - 1), "hash/merkle_cont")
        A("trans", mcont * (hidxn - hidx), "hash/merkle_idx_chain")
        A("trans", mcont * (hdirn - hdir), "hash/merkle_dir_chain")
        # MRUPDATE leg flags: binary, exclusive, merkle-only, stable across
        # the pair and along the leg together with the update id
        mro = f.main(C.H_MRO)
        mron = f.main(C.H_MRO, 1)
        mrn_ = f.main(C.H_MRN)
        mrnn = f.main(C.H_MRN, 1)
        mrid = f.main(C.H_MRID)
        mridn = f.main(C.H_MRID, 1)
        A("zero", fh * (mro * mro - mro), "hash/mro_bin")
        A("zero", fh * (mrn_ * mrn_ - mrn_), "hash/mrn_bin")
        A("zero", fh * mro * mrn_, "hash/mr_exclusive")
        A("zero", fh * (1 - hm) * (mro + mrn_), "hash/mr_merkle_only")
        A("trans", fh * is_input * (mron - mro), "hash/mro_pair")
        A("trans", fh * is_input * (mrnn - mrn_), "hash/mrn_pair")
        A("trans", fh * is_input * (mridn - mrid), "hash/mrid_pair")
        A("trans", mcont * (mron - mro), "hash/mro_chain")
        A("trans", mcont * (mrnn - mrn_), "hash/mrn_chain")
        A("trans", mcont * (mridn - mrid), "hash/mrid_chain")
        for i in range(4):
            cur = f.main(C.H_STATE[i])
            r0n = f.main(C.H_STATE[i], 1)
            r1n = f.main(C.H_STATE[4 + i], 1)
            A(
                "trans",
                mcont * (r0n - cur + hdir * (r1n - r0n)),
                f"hash/merkle_chain{i}",
            )

        # ---- ACE chiplet (docs chiplets/ace.md §constraints) --------------
        f_ace = s0 * s1 * s2 * (1 - s3)
        f_ace_n = s0n * s1n * s2n * (1 - s3n)
        a_ss = f.main(C.A_SSTART)
        a_ssn = f.main(C.A_SSTART, 1)
        a_sb = f.main(C.A_SBLOCK)
        a_sbn = f.main(C.A_SBLOCK, 1)
        f_read = 1 - a_sb
        f_eval = a_sb
        # region boundary flags: f_next = both rows in ACE and same
        # section; f_end = section's (or region's) final row
        f_ace_next = f_ace * (1 - s3n)
        f_next = f_ace_next * (1 - a_ssn)
        f_end = f_ace_next * a_ssn + f_ace * s3n
        A("zero", f_ace * (a_ss * a_ss - a_ss), "ace/sstart_bin")
        A("zero", f_ace * (a_sb * a_sb - a_sb), "ace/sblock_bin")
        A("first", f_ace * (1 - a_ss), "ace/first_row_start")
        A("trans", (1 - f_ace) * f_ace_n * (1 - a_ssn), "ace/region_start")
        A("trans", f_ace * s3n * a_ss, "ace/last_not_start")
        A("trans", f_ace_next * a_ss * a_ssn, "ace/min_two_rows")
        # block layout: sections open with READ, close with EVAL
        A("zero", f_ace * a_ss * a_sb, "ace/start_is_read")
        A("trans", f_next * f_eval * (1 - a_sbn), "ace/no_read_after_eval")
        A("trans", f_end * f_read, "ace/end_is_eval")
        a_ctx = f.main(C.A_CTX)
        a_ptr = f.main(C.A_PTR)
        a_clk = f.main(C.A_CLK)
        a_op = f.main(C.A_OP)
        a_id0 = f.main(C.A_ID0)
        a_id0n = f.main(C.A_ID0, 1)
        a_id1 = f.main(C.A_ID1)
        a_id2 = f.main(C.A_ID2)
        a_id2n = f.main(C.A_ID2, 1)
        a_v0 = [f.main(c) for c in C.A_V0]
        a_v1 = [f.main(c) for c in C.A_V1]
        a_v2 = [f.main(c) for c in C.A_V2]
        # READ→EVAL switch when the next id0 reaches the stored n_eval
        A(
            "trans",
            f_ace * f_read
            * ((1 - a_sbn) * a_id2n + a_sbn * a_id0n - a_id2),
            "ace/read_switch",
        )
        # section invariants: constant (ctx, clk); ptr += 4 (READ) or 1
        # (EVAL); id0 -= 2 (READ) or 1 (EVAL)
        A("trans", f_next * (f.main(C.A_CTX, 1) - a_ctx), "ace/ctx_const")
        A("trans", f_next * (f.main(C.A_CLK, 1) - a_clk), "ace/clk_const")
        A(
            "trans",
            f_next * (f.main(C.A_PTR, 1) - a_ptr - 4 * f_read - f_eval),
            "ace/ptr_step",
        )
        A(
            "trans",
            f_next * (a_id0 - a_id0n - 2 * f_read - f_eval),
            "ace/id0_step",
        )
        # READ rows create consecutive node ids
        A("zero", f_ace * f_read * (a_id1 - a_id0 + 1), "ace/read_ids")
        # EVAL: op ∈ {-1, 0, 1} and v0 = op²·(v1 + op·v2) + (1-op²)·v1·v2
        A("zero", f_ace * f_eval * a_op * (a_op * a_op - 1), "ace/op_valid")
        op2 = a_op * a_op
        vout0 = op2 * (a_v1[0] + a_op * a_v2[0]) + (1 - op2) * (
            a_v1[0] * a_v2[0] + 7 * (a_v1[1] * a_v2[1])
        )
        vout1 = op2 * (a_v1[1] + a_op * a_v2[1]) + (1 - op2) * (
            a_v1[0] * a_v2[1] + a_v1[1] * a_v2[0]
        )
        A("zero", f_ace * f_eval * (a_v0[0] - vout0), "ace/vout0")
        A("zero", f_ace * f_eval * (a_v0[1] - vout1), "ace/vout1")
        # final node: id 0 with value 0
        A("trans", f_end * a_id0, "ace/end_id0")
        A("trans", f_end * a_v0[0], "ace/end_v0_0")
        A("trans", f_end * a_v0[1], "ace/end_v0_1")

        # ---- buses ---------------------------------------------------------
        (resp, range_req, wiring, krom, sibling, wire,
         ace_mem) = chiplet_bus_columns(f)

        acc = f.aux(0)
        accn = f.aux(0, 1)
        total = acc
        for i, (V, U) in enumerate(
            (resp, range_req, wiring, krom, sibling, wire, ace_mem)
        ):
            av = f.aux(1 + i)
            A("trans", U * av - V, f"bus/col{i}")
            total = total + av
        A("trans", accn - total, "bus/acc")
        A("first", acc, "bus/acc_first")
        A("last", acc - f.aux_value(0), "bus/acc_final")

        # ---- flush ---------------------------------------------------------
        self.label_order = []
        sinks = (
            ("zero", f.assert_zero_many),
            ("trans", f.assert_transition_many),
            ("first", f.assert_zero_first_row_many),
            ("last", f.assert_zero_last_row_many),
        )
        for kind, sink in sinks:
            items = fam[kind]
            if items:
                sink(f.stack([e for e, _ in items]), f"family/{kind}")
                self.label_order.extend(label for _, label in items)

    def build_aux_trace(self, main, publics, aux_inputs, randomness):
        from .aux_numeric import build_device_aux

        return build_device_aux(
            self, main, publics, randomness, chiplet_bus_columns
        )
