"""Poseidon2 permutation AIR: 16-row packed cycles (docs
chiplets/hasher.md §poseidon2-permutation-air).

Each cycle proves one Poseidon2 permutation of a unique input state:
row 0 applies the initial linear layer plus the first external round,
rows 1-3 the remaining initial external rounds, rows 4-10 pack three
internal rounds each (witness columns hold the three s-box outputs so
every constraint stays degree ≤ 7 — witnesses are trace columns, not
symbolic substitutions), row 11 the final internal round (witness[0])
plus the first terminal external round, rows 12-14 the remaining
terminal rounds, and row 15 stores the output. witness[0] on rows 0/15
carries the perm-link multiplicity.

The perm-link (wiring) bus removes ``m × (perm_id, state)`` messages at
rows 0/15, balancing the hasher controller's per-request insertions.
"""

from __future__ import annotations

from .. import poseidon2_constants as PC
from ..air import Air
from . import chiplets as C
from .buses import BUS_WIRING_IN, BUS_WIRING_OUT, Challenges, mux

_M4 = ((2, 3, 1, 1), (1, 2, 3, 1), (1, 1, 2, 3), (3, 1, 1, 2))


def _mds_external(s):
    """External linear layer over 12 Exprs (poseidon2_host._mds_external)."""
    out = []
    for b in range(0, 12, 4):
        c = s[b : b + 4]
        for r in range(4):
            out.append(
                c[0] * _M4[r][0] + c[1] * _M4[r][1]
                + c[2] * _M4[r][2] + c[3] * _M4[r][3]
            )
    sums = [out[l] + out[4 + l] + out[8 + l] for l in range(4)]
    return [out[i] + sums[i & 3] for i in range(12)]


def _internal_linear(s):
    """Internal linear layer: out_i = Σs + diag_i·s_i."""
    total = s[0]
    for x in s[1:]:
        total = total + x
    return [total + s[i] * PC.MAT_DIAG[i] for i in range(12)]


def _sbox7(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x2 * x


def _periodic_round_constants():
    """12 period-16 columns: per-row constant vectors for the packed
    schedule (zeros where a row uses fewer than 12)."""
    rows = []
    rows.append(PC.ARK_EXT_INITIAL[0:12])  # row 0
    for r in range(1, 4):
        rows.append(PC.ARK_EXT_INITIAL[12 * r : 12 * r + 12])
    for pack in range(7):  # rows 4-10: three internal constants
        rows.append([*PC.ARK_INT[3 * pack : 3 * pack + 3], *([0] * 9)])
    rows.append(PC.ARK_EXT_TERMINAL[0:12])  # row 11 (terminal ext round 1)
    for r in range(1, 4):
        rows.append(PC.ARK_EXT_TERMINAL[12 * r : 12 * r + 12])
    rows.append([0] * 12)  # row 15
    return tuple(tuple(rows[r][i] for r in range(16)) for i in range(12))


def _sel(rows):
    return tuple(1 if r in rows else 0 for r in range(16))


def poseidon_wiring_columns(f):
    """Wiring-bus removals from cycle rows 0 and 15 with multiplicity
    witness[0]; shared by the constraint path and the aux builder."""
    ch = Challenges(f)
    one = f.const(1)
    sel0 = f.periodic(12)
    sel15 = f.periodic(15)
    perm = f.main(C.P_PERM)
    state = [f.main(c) for c in C.P_STATE]
    mult = f.main(C.P_WITNESS[0])
    neg_mult = mult * (-1 % (2**64 - 2**32 + 1))
    msg_in = ch.msg(BUS_WIRING_IN, [perm, *state])
    msg_out = ch.msg(BUS_WIRING_OUT, [perm, *state])
    wiring = mux(one, [
        (sel0, [(neg_mult, msg_in)]),
        (sel15, [(neg_mult, msg_out)]),
    ])
    return [wiring]


class Poseidon2PermutationAir(Air):
    width = C.POSEIDON_WIDTH
    aux_width = 2  # accumulator + wiring column
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 40
    periodic_columns = (
        *_periodic_round_constants(),  # 0..11
        _sel({0}),  # 12: row 0
        _sel({1, 2, 3, 12, 13, 14}),  # 13: plain external rounds
        _sel({4, 5, 6, 7, 8, 9, 10}),  # 14: packed internal rounds
        _sel({15}),  # 15: output row (row 11 = 1 - Σ others)
    )

    def eval(self, f) -> None:  # noqa: C901
        fam = {"zero": [], "trans": [], "first": [], "last": []}

        def A(kind, e, label):
            fam[kind].append((e, label))

        rc = [f.periodic(i) for i in range(12)]
        sel0 = f.periodic(12)
        sel_ext = f.periodic(13)
        sel_int = f.periodic(14)
        sel15 = f.periodic(15)
        sel11 = 1 - sel0 - sel_ext - sel_int - sel15

        s = [f.main(c) for c in C.P_STATE]
        sn = [f.main(c, 1) for c in C.P_STATE]
        w = [f.main(c) for c in C.P_WITNESS]
        perm = f.main(C.P_PERM)
        permn = f.main(C.P_PERM, 1)

        # row 0: initial linear layer + first external round
        m0 = _mds_external(s)
        out0 = _mds_external([_sbox7(m0[i] + rc[i]) for i in range(12)])
        for i in range(12):
            A("trans", sel0 * (sn[i] - out0[i]), f"row0/s{i}")
        # plain external rounds
        oute = _mds_external([_sbox7(s[i] + rc[i]) for i in range(12)])
        for i in range(12):
            A("trans", sel_ext * (sn[i] - oute[i]), f"ext/s{i}")
        # packed internal rounds: witnesses are columns, so each chained
        # s-box constraint stays degree 7
        A("trans", sel_int * (w[0] - _sbox7(s[0] + rc[0])), "int/w0")
        t1 = _internal_linear([w[0], *s[1:]])
        A("trans", sel_int * (w[1] - _sbox7(t1[0] + rc[1])), "int/w1")
        t2 = _internal_linear([w[1], *t1[1:]])
        A("trans", sel_int * (w[2] - _sbox7(t2[0] + rc[2])), "int/w2")
        t3 = _internal_linear([w[2], *t2[1:]])
        for i in range(12):
            A("trans", sel_int * (sn[i] - t3[i]), f"int/s{i}")
        # row 11: final internal round (hardcoded constant) + terminal
        # external round 1 (periodic constants)
        A("trans", sel11 * (w[0] - _sbox7(s[0] + PC.ARK_INT[21])), "row11/w0")
        t = _internal_linear([w[0], *s[1:]])
        out11 = _mds_external([_sbox7(t[i] + rc[i]) for i in range(12)])
        for i in range(12):
            A("trans", sel11 * (sn[i] - out11[i]), f"row11/s{i}")

        # witness zeroing where unused
        A("zero", sel_ext * w[0], "wit/w0_ext")
        for i in (1, 2):
            A("zero", (1 - sel_int) * w[i], f"wit/w{i}_zero")

        # perm id: 0 at the start, stable in-cycle, +1 across cycles
        A("first", perm, "perm/first")
        A("trans", (1 - sel15) * (permn - perm), "perm/stable")
        A("trans", sel15 * (permn - perm - 1), "perm/incr")

        # wiring bus
        (wiring,) = poseidon_wiring_columns(f)
        acc = f.aux(0)
        accn = f.aux(0, 1)
        av = f.aux(1)
        V, U = wiring
        A("trans", U * av - V, "bus/wiring")
        A("trans", accn - acc - av, "bus/acc")
        A("first", acc, "bus/acc_first")
        A("last", acc - f.aux_value(0), "bus/acc_final")

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
