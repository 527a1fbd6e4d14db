"""Arbitrary-length keccak256 precompile: multi-block round chiplet +
canonical chunk-sponge chiplet (stage 3).

Covers the reference's chunked keccak scope
(precompiles-prover/src/hash/{keccak/sponge, chunk, chunk_node,
memory64.rs}) — messages of any byte length — with a TPU-first
arithmetization continuing precompile/keccak.py's bit-column design:

* **KeccakVarAir**: one keccak-f[1600] round per row, 32-row cycles,
  one cycle per 136-byte rate block. Message bits live in 1088
  dedicated columns; a 136-column byte mask (``sel``) separates message
  from pad10*1 at the length boundary, so the SAME constraints cover
  full blocks, the padded final block, and the empty message. State
  chains across blocks by XOR-absorption at cycle boundaries (final
  state copied through the idle rows 25..31 so the transition is
  local).
* **SpongeAir**: a Poseidon2 chunk sponge computing canonical
  deferred-node digests (vm/deferred.py Node.digest): per claim, a
  5·nb-chunk sponge over the masked message (hm — the CHUNKS message
  node, deferred.keccak_message_chunks layout) and a 1-chunk sponge
  over the digest (ho), each absorb wired to the shared Poseidon2
  permutation AIR with the capacity threaded between rows.

Cross-chiplet binding (all LogUp, order-free):

  KeccakVarAir --[chunk bus: (kidx, len, cidx, limbs8)]--> SpongeAir
  SpongeAir    --[kstmt bus: (len, hm, ho)]--> ChainAir (join path)
  SpongeAir    --[range bus: len/nb binding]--> RangeTableAir

``kidx`` is the dense per-chiplet claim index: both sides count their
arbitrary-length claims 0, 1, ... so the multiset equality of
(kidx, len, cidx, chunk) messages forces the j-th sponge to absorb
exactly the j-th keccak claim's masked message and digest. The chain's
join row then computes stmt = P([hm, ho, 6, len, 0, 0]) — the canonical
digest of Join(tag=[PID_KECCAK256, len, 0, 0], msg_node, out_node) —
and folds it into the deferred root.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..field import gl
from ..hash.keccak_host import ROTATIONS, ROUND_CONSTANTS, keccak256
from ..stark.air import Air
from ..vm.constraints.buses import BUS_WIRING_IN, BUS_WIRING_OUT, Challenges, mux
from ..vm.deferred import PID_KECCAK256 as KECCAK_VAR_ID
from ..vm.deferred import keccak_message_chunks
from .keccak import _round  # shared host round with theta-D witness

P = gl.P
RATE = 136
CYCLE = 32
ROUNDS = 24
OUT_ROW = ROUNDS

#: session-local bus ids (session.py owns 12/13)
SBUS_CHUNK = 14
SBUS_KSTMT = 15


@dataclass(frozen=True)
class KeccakClaim:
    """Claim: out = keccak256(message) for any byte length."""

    message: bytes

    @cached_property  # read several times by the trace builders
    def out(self) -> int:
        return int.from_bytes(keccak256(self.message), "little")

    @property
    def id(self) -> int:
        return KECCAK_VAR_ID

    @property
    def n_blocks(self) -> int:
        return max(1, -(-(len(self.message) + 1) // RATE))


# ---------------------------------------------------------------------------
# KeccakVarAir column layout
# ---------------------------------------------------------------------------

V_ACT = 0
V_KIDX = 1
V_LEN = 2
V_NB = 3
V_BLK = 4
V_LAST = 5
V_A0 = 6  # 1600 state bits: (x, y, z) at V_A0 + 64*(x + 5y) + z
V_D0 = V_A0 + 1600  # 320 theta-D bits
V_M0 = V_D0 + 320  # 1088 rate message/pad bits for this block
V_S0 = V_M0 + 1088  # 136 byte-mask bits (1 = message byte)
KECCAK_VAR_WIDTH = V_S0 + 136

# periodic column indices (period-32)
PZ_FIRST, PZ_ROUND, PZ_OUT, PZ_END, PZ_COPY = 0, 1, 2, 3, 4
PZ_RC0 = 5


def _build_tables(a0: int, d0: int):
    """rho/pi/chi/theta index tables over this AIR's column offsets
    (same derivation as keccak.py:_build_tables)."""
    b_src_a = [0] * 1600
    b_src_d = [0] * 1600
    for b_lane in range(25):
        y = b_lane % 5
        x = (3 * (b_lane // 5 - 3 * y)) % 5
        r = ROTATIONS[x][y]
        a_lane = x + 5 * y
        for zp in range(64):
            src_z = (zp - r) % 64
            b_src_a[64 * b_lane + zp] = a0 + 64 * a_lane + src_z
            b_src_d[64 * b_lane + zp] = d0 + 64 * (a_lane % 5) + src_z
    chi = {0: [], 1: [], 2: []}
    for lane in range(25):
        u, v = lane % 5, lane // 5
        for z in range(64):
            chi[0].append(64 * (u + 5 * v) + z)
            chi[1].append(64 * ((u + 1) % 5 + 5 * v) + z)
            chi[2].append(64 * ((u + 2) % 5 + 5 * v) + z)
    parity = []
    for t in range(10):
        lst = []
        for x in range(5):
            for z in range(64):
                if t < 5:
                    lst.append(a0 + 64 * ((x + 4) % 5 + 5 * t) + z)
                else:
                    lst.append(
                        a0 + 64 * ((x + 1) % 5 + 5 * (t - 5)) + ((z + 63) % 64)
                    )
        parity.append(lst)
    return b_src_a, b_src_d, chi, parity


_B_SRC_A, _B_SRC_D, _CHI, _PARITY = _build_tables(V_A0, V_D0)


def _periodic_patterns():
    pats = [
        tuple(1 if r == 0 else 0 for r in range(CYCLE)),
        tuple(1 if r < ROUNDS else 0 for r in range(CYCLE)),
        tuple(1 if r == OUT_ROW else 0 for r in range(CYCLE)),
        tuple(1 if r == CYCLE - 1 else 0 for r in range(CYCLE)),
        tuple(1 if OUT_ROW <= r < CYCLE - 1 else 0 for r in range(CYCLE)),
    ]
    for z in range(64):
        pats.append(
            tuple(
                (ROUND_CONSTANTS[r] >> z) & 1 if r < ROUNDS else 0
                for r in range(CYCLE)
            )
        )
    return tuple(pats)


def _xor(a, b):
    return a + b - a * b * 2


def _masked_chunk_limbs(f, c: int):
    """Masked 8-limb chunk ``c`` of this block's message bits: bit t of
    limb l is m[256c+32l+t] * sel[byte]. Chunk 4 carries the final 8
    bytes of the rate (limbs 2..7 zero), matching
    deferred.keccak_message_chunks."""
    limbs = []
    n_limbs = 8 if c < 4 else 2
    for l in range(8):
        if l >= n_limbs:
            limbs.append(0)
            continue
        e = None
        for t in range(32):
            bit = 256 * c + 32 * l + t
            byte = bit // 8
            term = f.main(V_M0 + bit) * f.main(V_S0 + byte) * (1 << t)
            e = term if e is None else e + term
        limbs.append(e)
    return limbs


def keccak_var_bus_columns(f):
    """6 fraction columns: 5 masked message-chunk insertions (cycle row
    0) + the digest-chunk insertion (last block's out row)."""
    ch = Challenges(f)
    one = f.const(1)
    act = f.main(V_ACT)
    kidx = f.main(V_KIDX)
    length = f.main(V_LEN)
    blk = f.main(V_BLK)
    last = f.main(V_LAST)
    pfirst = f.periodic(PZ_FIRST)
    pout = f.periodic(PZ_OUT)

    cols = []
    for c in range(5):
        msg = ch.msg(
            SBUS_CHUNK, [kidx, length, blk * 5 + c, *_masked_chunk_limbs(f, c)]
        )
        cols.append(mux(one, [(act * pfirst, [(1, msg)])]))

    # digest limbs: state bits 0..255 on the out row
    out_limbs = []
    for l in range(8):
        e = f.main(V_A0 + 32 * l)
        for t in range(1, 32):
            e = e + f.main(V_A0 + 32 * l + t) * (1 << t)
        out_limbs.append(e)
    msg = ch.msg(SBUS_CHUNK, [kidx, length, (blk + 1) * 5, *out_limbs])
    cols.append(mux(one, [(act * pout * last, [(1, msg)])]))
    return cols


class KeccakVarAir(Air):
    """Multi-block keccak-f[1600] round AIR with in-trace padding."""

    width = KECCAK_VAR_WIDTH
    aux_width = 1 + 6
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 8
    periodic_columns = _periodic_patterns()

    def eval(self, f) -> None:
        fam = []

        act = f.main(V_ACT)
        actn = f.main(V_ACT, 1)
        pfirst = f.periodic(PZ_FIRST)
        pround = f.periodic(PZ_ROUND)
        pend = f.periodic(PZ_END)
        pcopy = f.periodic(PZ_COPY)
        kidx, kidxn = f.main(V_KIDX), f.main(V_KIDX, 1)
        length, lengthn = f.main(V_LEN), f.main(V_LEN, 1)
        nb, nbn = f.main(V_NB), f.main(V_NB, 1)
        blk, blkn = f.main(V_BLK), f.main(V_BLK, 1)
        last, lastn = f.main(V_LAST), f.main(V_LAST, 1)
        n_claims, n_u256, n_km = f.public(4), f.public(5), f.public(6)
        # EC claims are not arbitrary-length keccak claims either: ``miden_tpu``
        # leaves public 7 (n_ec) out here, so a session mixing EC and
        # arbitrary-length keccak claims breaks act/claim_count there.
        # Equal to ``miden_tpu`` whenever n_ec = 0.
        n_arb = n_claims - n_u256 - n_km - f.public(7)

        # -- activity / schedule --
        fam.append(("zero", act * (act - 1), ["act/bool"]))
        fam.append(("zero", last * (last - 1), ["last/bool"]))
        fam.append(("trans", (1 - pend) * (actn - act), ["act/in_cycle"]))
        fam.append(("trans", (1 - act) * actn, ["act/monotone"]))
        fam.append(("first", act - 1, ["act/first"]))
        fam.append(("first", kidx, ["kidx/first"]))
        fam.append(("first", blk, ["blk/first"]))
        # claim fields stable within a cycle
        for name, cur, nxt in (
            ("kidx", kidx, kidxn),
            ("len", length, lengthn),
            ("nb", nb, nbn),
            ("blk", blk, blkn),
            ("last", last, lastn),
        ):
            fam.append(
                ("trans", (1 - pend) * (nxt - cur), [f"{name}/in_cycle"])
            )
        # last <=> blk = nb - 1 (reverse direction enforced by the chunk
        # bus: lying keeps emitting chunks the sponge never absorbs)
        fam.append(("zero", act * last * (blk - nb + 1), ["last/binding"]))
        # cycle boundary: continuation vs new claim
        cont = pend * actn * (1 - last)
        new = pend * actn * last
        fam.append(("trans", cont * (blkn - blk - 1), ["blk/step"]))
        fam.append(("trans", cont * (kidxn - kidx), ["kidx/cont"]))
        fam.append(("trans", cont * (lengthn - length), ["len/cont"]))
        fam.append(("trans", cont * (nbn - nb), ["nb/cont"]))
        fam.append(("trans", new * (kidxn - kidx - 1), ["kidx/step"]))
        fam.append(("trans", new * blkn, ["blk/reset"]))
        # act drop only at a claim boundary, after n_arb claims
        fam.append(("trans", pend * (act - actn) * (1 - last), ["act/drop_last"]))
        fam.append(
            (
                "trans",
                pend * (act - actn) * (kidx - n_arb + 1),
                ["act/claim_count"],
            )
        )

        # -- booleanity --
        a_all = f.main_many(range(V_A0, V_A0 + 1600))
        fam.append(
            ("zero", a_all * (a_all - 1), [f"bool/a{i}" for i in range(1600)])
        )
        d_all = f.main_many(range(V_D0, V_D0 + 320))
        fam.append(
            ("zero", d_all * (d_all - 1), [f"bool/d{i}" for i in range(320)])
        )
        m_all = f.main_many(range(V_M0, V_M0 + 1088))
        fam.append(
            ("zero", m_all * (m_all - 1), [f"bool/m{i}" for i in range(1088)])
        )
        s_all = f.main_many(range(V_S0, V_S0 + 136))
        fam.append(
            ("zero", s_all * (s_all - 1), [f"bool/s{i}" for i in range(136)])
        )

        # -- theta-D parity (as keccak.py) --
        S = f.main_many(_PARITY[0])
        for t in range(1, 10):
            S = S + f.main_many(_PARITY[t])
        E = S - d_all
        prod = E
        for k in range(1, 6):
            prod = prod * (E - 2 * k)
        fam.append(
            ("zero", pround * prod, [f"theta/parity{i}" for i in range(320)])
        )

        # -- round transition (iota folded into the next state) --
        def chi_expr(positions):
            ops = []
            for slot in range(3):
                bp = [_CHI[slot][p] for p in positions]
                A = f.main_many([_B_SRC_A[j] for j in bp])
                D = f.main_many([_B_SRC_D[j] for j in bp])
                ops.append(_xor(A, D))
            b0, b1, b2 = ops
            return _xor(b0, (1 - b1) * b2)

        rest = list(range(64, 1600))
        nxt = f.main_many([V_A0 + i for i in rest], offset=1)
        fam.append(
            (
                "trans",
                act * pround * (nxt - chi_expr(rest)),
                [f"round/bit{i}" for i in rest],
            )
        )
        lane0 = list(range(64))
        nxt0 = f.main_many([V_A0 + i for i in lane0], offset=1)
        rcv = f.stack([f.periodic(PZ_RC0 + z) for z in range(64)])
        fam.append(
            (
                "trans",
                act * pround * (_xor(nxt0, rcv) - chi_expr(lane0)),
                [f"round/iota{i}" for i in lane0],
            )
        )

        # -- state copy through idle rows (so absorption is local) --
        copy_nxt = f.main_many(range(V_A0, V_A0 + 1600), offset=1)
        fam.append(
            (
                "trans",
                act * pcopy * (copy_nxt - a_all),
                [f"copy/bit{i}" for i in range(1600)],
            )
        )

        # -- absorption at cycle row 0 --
        # first cycle of a claim: A_rate = m, A_capacity = 0;
        # continuation: A'_rate = A_out xor m', A'_capacity = A_out.
        rate_now = f.main_many(range(V_A0, V_A0 + 1088))
        cap_now = f.main_many(range(V_A0 + 1088, V_A0 + 1600))
        fam.append(
            (
                "first",
                rate_now - m_all,
                [f"absorb/first_rate{i}" for i in range(1088)],
            )
        )
        fam.append(
            ("first", cap_now, [f"absorb/first_cap{i}" for i in range(512)])
        )
        rate_nxt = f.main_many(range(V_A0, V_A0 + 1088), offset=1)
        cap_nxt = f.main_many(range(V_A0 + 1088, V_A0 + 1600), offset=1)
        m_nxt = f.main_many(range(V_M0, V_M0 + 1088), offset=1)
        fam.append(
            (
                "trans",
                cont * (rate_nxt - _xor(rate_now, m_nxt)),
                [f"absorb/cont_rate{i}" for i in range(1088)],
            )
        )
        fam.append(
            (
                "trans",
                cont * (cap_nxt - cap_now),
                [f"absorb/cont_cap{i}" for i in range(512)],
            )
        )
        fam.append(
            (
                "trans",
                new * (rate_nxt - m_nxt),
                [f"absorb/new_rate{i}" for i in range(1088)],
            )
        )
        fam.append(
            (
                "trans",
                new * cap_nxt,
                [f"absorb/new_cap{i}" for i in range(512)],
            )
        )

        # -- byte mask + pad10*1 (cycle row 0 only), vectorized --
        sel = [f.main(V_S0 + b) for b in range(136)]
        sel_lo = f.main_many(range(V_S0, V_S0 + 135))
        sel_hi = f.main_many(range(V_S0 + 1, V_S0 + 136))
        fam.append(
            (
                "zero",
                act * pfirst * (1 - sel_lo) * sel_hi,
                [f"mask/monotone{b}" for b in range(135)],
            )
        )
        # full (non-last) blocks carry 136 message bytes
        fam.append(
            (
                "zero",
                act * pfirst * (1 - last) * (s_all - 1),
                [f"mask/full{b}" for b in range(136)],
            )
        )
        # last block: mask boundary at len - 136*(nb-1) message bytes
        ssum = sel[0]
        for b in range(1, 136):
            ssum = ssum + sel[b]
        fam.append(
            (
                "zero",
                act * pfirst * last * (ssum - (length - (nb - 1) * 136)),
                ["mask/boundary"],
            )
        )
        # pad bytes on the last block: 0x01 at the first pad byte, zeros
        # between, 0x80 folded into byte 135 (0x81 when it is also first).
        # One vectorized family per bit position over the 136 bytes.
        lastg = act * pfirst * last
        notsel = 1 - s_all
        # pb[b] = first-pad indicator = sel[b-1] - sel[b] (sel[-1] := 1)
        pb = f.stack([(1 - sel[0])] + [sel[b - 1] - sel[b] for b in range(1, 136)])
        for t in range(8):
            m_t = f.main_many(range(V_M0 + t, V_M0 + 1088 + t, 8))
            if t == 0:
                expr = lastg * notsel * (m_t - pb)
            elif t < 7:
                expr = lastg * notsel * m_t
            else:
                hi = f.stack([f.const(1 if b == 135 else 0) for b in range(136)])
                expr = lastg * notsel * (m_t - hi)
            fam.append(
                ("zero", expr, [f"pad/bit{t}_{b}" for b in range(136)])
            )

        # -- buses --
        cols = keccak_var_bus_columns(f)
        acc = f.aux(0)
        accn = f.aux(0, 1)
        for k, (V, U) in enumerate(cols):
            av = f.aux(1 + k)
            fam.append(("trans", U * av - V, [f"bus/frac{k}"]))
        total = f.aux(1)
        for k in range(1, len(cols)):
            total = total + f.aux(1 + k)
        fam.append(("trans", accn - acc - total, ["bus/acc"]))
        fam.append(("first", acc, ["bus/acc_first"]))
        fam.append(("last", acc - f.aux_value(0), ["bus/acc_final"]))

        self.label_order = []
        sinks = {
            "zero": f.assert_zero_many,
            "trans": f.assert_transition_many,
            "first": f.assert_zero_first_row_many,
            "last": f.assert_zero_last_row_many,
        }
        for kind, expr, labels in fam:
            sinks[kind](expr, labels[0])
            self.label_order.extend(labels)

    def build_aux_trace(self, main, publics, aux_inputs, randomness):
        from ..vm.constraints.aux_numeric import build_device_aux

        return build_device_aux(
            self, main, publics, randomness, keccak_var_bus_columns
        )


# ---------------------------------------------------------------------------
# SpongeAir: canonical chunk-sponge node digests
# ---------------------------------------------------------------------------

S_ACT = 0
S_PERM = 1
S_KIDX = 2
S_LEN = 3
S_NB = 4
S_CIDX = 5
S_OB = 6  # 1 = this row absorbs the digest chunk (out-node sponge)
S_HM = list(range(7, 11))  # message-node digest, pinned on ob rows
S_CAP = list(range(11, 15))  # sponge capacity in
S_CHUNK = list(range(15, 23))  # absorbed chunk (8 limbs)
S_OUT = list(range(23, 35))  # full permutation output state
SPONGE_WIDTH = 35


def sponge_bus_columns(f):
    """4 fraction columns: permutation wiring (in+out), chunk removal,
    kstmt insertion, len/nb range binding."""
    ch = Challenges(f)
    one = f.const(1)
    act = f.main(S_ACT)
    perm = f.main(S_PERM)
    kidx = f.main(S_KIDX)
    length = f.main(S_LEN)
    nb = f.main(S_NB)
    cidx = f.main(S_CIDX)
    ob = f.main(S_OB)
    hm = [f.main(c) for c in S_HM]
    cap = [f.main(c) for c in S_CAP]
    chunk = [f.main(c) for c in S_CHUNK]
    out = [f.main(c) for c in S_OUT]

    msg_in = ch.msg(BUS_WIRING_IN, [perm, *chunk, *cap])
    msg_out = ch.msg(BUS_WIRING_OUT, [perm, *out])
    cols = [mux(one, [(act, [(1, msg_in), (1, msg_out)])])]

    chunk_msg = ch.msg(SBUS_CHUNK, [kidx, length, cidx, *chunk])
    cols.append(mux(one, [(act, [(-1, chunk_msg)])]))

    kstmt = ch.msg(SBUS_KSTMT, [length, *hm, *out[0:4]])
    cols.append(mux(one, [(act * ob, [(1, kstmt)])]))

    from .session import SBUS_RANGE

    lo = length - (nb - 1) * 136
    hi = nb * 136 - 1 - length
    fracs = [(1, ch.msg(SBUS_RANGE, [lo])), (1, ch.msg(SBUS_RANGE, [hi]))]
    cols.append(mux(one, [(act * ob, fracs)]))
    return cols


class SpongeAir(Air):
    """Canonical deferred-node chunk sponge over the Poseidon2 AIR.

    Per claim: rows cidx = 0 .. 5·nb-1 absorb the masked message chunks
    (capacity [2,0,0,0] at cidx 0, threaded out[8:12] after), producing
    hm on the last message row; the ob row absorbs the digest chunk as
    a fresh 1-chunk sponge producing ho, emits the claim statement
    message, and range-binds (len, nb)."""

    width = SPONGE_WIDTH
    aux_width = 1 + 4
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 8

    def eval(self, f) -> None:
        fam = []

        act = f.main(S_ACT)
        actn = f.main(S_ACT, 1)
        perm, permn = f.main(S_PERM), f.main(S_PERM, 1)
        kidx, kidxn = f.main(S_KIDX), f.main(S_KIDX, 1)
        length, lengthn = f.main(S_LEN), f.main(S_LEN, 1)
        nb, nbn = f.main(S_NB), f.main(S_NB, 1)
        cidx, cidxn = f.main(S_CIDX), f.main(S_CIDX, 1)
        ob, obn = f.main(S_OB), f.main(S_OB, 1)
        hmn = [f.main(c, 1) for c in S_HM]
        cap = [f.main(c) for c in S_CAP]
        capn = [f.main(c, 1) for c in S_CAP]
        out = [f.main(c) for c in S_OUT]
        n_claims, n_u256, n_km = f.public(4), f.public(5), f.public(6)
        # EC claims are not arbitrary-length keccak claims either: ``miden_tpu``
        # leaves public 7 (n_ec) out here, so a session mixing EC and
        # arbitrary-length keccak claims breaks act/claim_count there.
        # Equal to ``miden_tpu`` whenever n_ec = 0.
        n_arb = n_claims - n_u256 - n_km - f.public(7)

        fam.append(("zero", act * (act - 1), ["act/bool"]))
        fam.append(("zero", ob * (ob - 1), ["ob/bool"]))
        fam.append(("zero", (1 - act) * ob, ["ob/pad_zero"]))
        fam.append(("trans", (1 - act) * actn, ["act/monotone"]))
        fam.append(("last", act, ["act/last_padding"]))
        fam.append(("first", act - 1, ["act/first"]))
        fam.append(("first", kidx, ["kidx/first"]))
        fam.append(("first", cidx, ["cidx/first"]))
        fam.append(
            (
                "first",
                perm - (n_claims + n_u256 + n_km) * 3 - f.public(7) * 6,
                ["perm/first"],
            )
        )
        for i in range(4):
            want = 2 if i == 0 else 0
            fam.append(("first", cap[i] - want, [f"cap/first{i}"]))
        fam.append(("trans", actn * (permn - perm - 1), ["perm/step"]))
        # within a claim (current row not ob): fields stable, cidx += 1
        within = actn * (1 - ob)
        fam.append(("trans", within * (kidxn - kidx), ["kidx/within"]))
        fam.append(("trans", within * (lengthn - length), ["len/within"]))
        fam.append(("trans", within * (nbn - nb), ["nb/within"]))
        fam.append(("trans", within * (cidxn - cidx - 1), ["cidx/step"]))
        # ob row ends the claim: next row starts fresh
        boundary = actn * ob
        fam.append(("trans", boundary * (kidxn - kidx - 1), ["kidx/step"]))
        fam.append(("trans", boundary * cidxn, ["cidx/reset"]))
        # capacity threading: fresh [2,0,0,0] entering an ob row (the
        # digest sponge) or a new claim; out[8:12] within the message
        # sponge
        for i in range(4):
            want = 2 if i == 0 else 0
            fam.append(
                (
                    "trans",
                    actn * obn * (capn[i] - want),
                    [f"cap/ob_fresh{i}"],
                )
            )
            fam.append(
                ("trans", boundary * (capn[i] - want), [f"cap/new_claim{i}"])
            )
            fam.append(
                (
                    "trans",
                    within * (1 - obn) * (capn[i] - out[8 + i]),
                    [f"cap/thread{i}"],
                )
            )
        # ob sits exactly at cidx = 5*nb; hm = message-sponge rate out
        fam.append(("zero", ob * (cidx - nb * 5), ["ob/position"]))
        for i in range(4):
            fam.append(
                (
                    "trans",
                    actn * obn * (hmn[i] - out[i]),
                    [f"hm/pinned{i}"],
                )
            )
        # the active region ends on an ob row, after n_arb claims
        fam.append(("trans", (act - actn) * (1 - ob), ["act/end_on_ob"]))
        fam.append(
            ("trans", (act - actn) * (kidx - n_arb + 1), ["act/claim_count"])
        )

        cols = sponge_bus_columns(f)
        acc = f.aux(0)
        accn = f.aux(0, 1)
        for k, (V, U) in enumerate(cols):
            av = f.aux(1 + k)
            fam.append(("trans", U * av - V, [f"bus/frac{k}"]))
        total = f.aux(1)
        for k in range(1, len(cols)):
            total = total + f.aux(1 + k)
        fam.append(("trans", accn - acc - total, ["bus/acc"]))
        fam.append(("first", acc, ["bus/acc_first"]))
        fam.append(("last", acc - f.aux_value(0), ["bus/acc_final"]))

        self.label_order = []
        sinks = {
            "zero": f.assert_zero_many,
            "trans": f.assert_transition_many,
            "first": f.assert_zero_first_row_many,
            "last": f.assert_zero_last_row_many,
        }
        for kind, expr, labels in fam:
            sinks[kind](expr, labels[0])
            self.label_order.extend(labels)

    def build_aux_trace(self, main, publics, aux_inputs, randomness):
        from ..vm.constraints.aux_numeric import build_device_aux

        return build_device_aux(
            self, main, publics, randomness, sponge_bus_columns
        )


# ---------------------------------------------------------------------------
# Trace builders
# ---------------------------------------------------------------------------

_Z = np.arange(64, dtype=np.uint64)


def _write_bits(row, col0, lanes):
    for L, v in enumerate(lanes):
        row[col0 + 64 * L : col0 + 64 * L + 64] = (
            np.uint64(v) >> _Z
        ) & np.uint64(1)


def _pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def build_keccak_var_trace(claims) -> np.ndarray:
    """(rows, KECCAK_VAR_WIDTH) u64 trace: 32·nb rows per claim."""
    total_cycles = sum(cl.n_blocks for cl in claims)
    n_cycles = _pow2(total_cycles + 1)  # >= 1 padding cycle
    mat = np.zeros((CYCLE * n_cycles, KECCAK_VAR_WIDTH), dtype=np.uint64)

    cyc = 0
    for j, cl in enumerate(claims):
        msg = cl.message
        nb = cl.n_blocks
        padded = bytearray(msg) + bytearray(RATE * nb - len(msg))
        padded[len(msg)] ^= 0x01
        padded[RATE * nb - 1] ^= 0x80
        lanes = [0] * 25
        for b in range(nb):
            rows = mat[CYCLE * cyc : CYCLE * (cyc + 1)]
            rows[:, V_ACT] = 1
            rows[:, V_KIDX] = j
            rows[:, V_LEN] = len(msg)
            rows[:, V_NB] = nb
            rows[:, V_BLK] = b
            rows[:, V_LAST] = 1 if b == nb - 1 else 0
            block = padded[RATE * b : RATE * (b + 1)]
            # message/pad bits + byte mask on row 0
            mbits = np.unpackbits(
                np.frombuffer(bytes(block), dtype=np.uint8), bitorder="little"
            )
            rows[0, V_M0 : V_M0 + 1088] = mbits
            rem = min(max(len(msg) - RATE * b, 0), RATE)
            rows[0, V_S0 : V_S0 + rem] = 1
            # absorb: state ^= block (rate)
            for i in range(17):
                lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
            for r in range(ROUNDS):
                _write_bits(rows[r], V_A0, lanes)
                d, lanes = _round(lanes, ROUND_CONSTANTS[r])
                rows[r, V_D0 : V_D0 + 320] = np.concatenate(
                    [((np.uint64(v) >> _Z) & np.uint64(1)) for v in d]
                )
            for r in range(OUT_ROW, CYCLE):  # final state held to the end
                _write_bits(rows[r], V_A0, lanes)
            cyc += 1
    return mat


def build_sponge_trace(claims, perm_base: int, perm_cycles: list):
    """(rows, SPONGE_WIDTH) u64 trace (5·nb + 1 rows per claim) plus the
    appended Poseidon2 cycles; returns (trace, per-claim (hm, ho))."""
    from ..hash import poseidon2_host as hp

    total = sum(5 * cl.n_blocks + 1 for cl in claims)
    rows_n = _pow2(total + 1)
    mat = np.zeros((rows_n, SPONGE_WIDTH), dtype=np.uint64)
    digests = []

    r = 0
    for j, cl in enumerate(claims):
        msg_chunks = keccak_message_chunks(cl.message)
        assert len(msg_chunks) == 5 * cl.n_blocks
        out_chunk = [(cl.out >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        state = [0] * 8 + [2, 0, 0, 0]
        hm = None
        for cidx, chunk in enumerate([*msg_chunks, out_chunk]):
            is_ob = cidx == len(msg_chunks)
            if is_ob:
                hm = tuple(state[0:4])  # message sponge result
                state = [0] * 8 + [2, 0, 0, 0]  # fresh digest sponge
            row = mat[r]
            row[S_ACT] = 1
            row[S_PERM] = perm_base + r
            row[S_KIDX] = j
            row[S_LEN] = len(cl.message)
            row[S_NB] = cl.n_blocks
            row[S_CIDX] = cidx
            row[S_OB] = 1 if is_ob else 0
            row[S_CAP] = state[8:12]
            row[S_CHUNK] = chunk
            in_state = [*chunk, *state[8:12]]
            state = hp.permute(in_state)
            row[S_OUT] = state
            if is_ob:
                row[S_HM] = hm
            perm_cycles.append((in_state, 1))
            r += 1
        digests.append((hm, tuple(state[0:4])))
    # pad unused poseidon slots? no - cycles list is dense by construction
    return mat, digests
