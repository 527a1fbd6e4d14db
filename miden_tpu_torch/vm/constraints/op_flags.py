"""Operation flags computed from decoder op bits.

Degree-reduction scheme (air/src/constraints/op_flags/mod.rs, docs
stack/op_constraints.md §operation flags):

    b6 b5 b4 | flag degree | mechanism
    ---------+-------------+----------------------------------
     0  x  x |     7       | full 7-bit product
     1  0  0 |     6       | u32 group, b0 forced 0 (6 bits)
     1  0  1 |     5       | extra[0] = b6·(1-b5)·b4
     1  1  x |     4       | extra[1] = b6·b5, b0/b1 forced 0

All flags are mutually exclusive; exactly one is 1 per row. Composite
flags (shift left/right, control flow) follow the prefix tricks in
op_constraints.md §composite flags.
"""

from __future__ import annotations

from ..ops import OPCODES
from .. import layout as L


class OpFlags:
    """Per-operation and composite flag expressions for one row window.

    `flags[name]` is the op flag Expr for the opcode `name`;
    `next_ctrl[name]` gives degree-4-or-less next-row flags for the
    control ops needed by decoder constraints (END, REPEAT, RESPAN, HALT).
    """

    def __init__(self, f):
        self.f = f
        b = [f.main(L.OP_BITS[i]) for i in range(7)]
        e0 = f.main(L.EXTRA[0])
        e1 = f.main(L.EXTRA[1])
        self.bits = b
        self.e0 = e0
        self.e1 = e1
        self.flags = self._build(b, e0, e1)
        bn = [f.main(L.OP_BITS[i], 1) for i in range(7)]
        e1n = f.main(L.EXTRA[1], 1)
        self.next_ctrl = self._build_next_ctrl(bn, e1n)
        self._composites()

    # -- flag tables ---------------------------------------------------------

    @staticmethod
    def _sel(bit, v: int):
        return bit if v else 1 - bit

    def _low_table(self, bits, width: int):
        """All 2^width products of selectors over `bits`; index i selects
        bit k = (i >> k) & 1. Built level by level so shared subproducts
        are reused (mirrors op_flags/mod.rs's iterative tables)."""
        cur = [self.f.const(1)]
        for k in range(width):
            cur = [t * self._sel(bits[k], v) for v in (0, 1) for t in cur]
        return cur

    def _build(self, b, e0, e1):
        f = self.f
        flags = {}
        low4 = self._low_table(b, 4)  # products over b0..b3
        not6 = 1 - b[6]
        # degree-7 (opcodes 0..63): (1-b6)·sel(b5)·sel(b4)·low4
        hi = {
            (v5, v4): not6 * self._sel(b[5], v5) * self._sel(b[4], v4)
            for v5 in (0, 1)
            for v4 in (0, 1)
        }
        # degree-6 u32 group (64..79, prefix 100, b0 forced 0)
        u32pre = b[6] * (1 - b[5]) * (1 - b[4])
        self.u32_rc = u32pre  # range-check selector f_u32rc (degree 3)
        low3 = self._low_table(b[1:4], 3)  # products over b1..b3
        # degree-4 group (96..127, prefix 11, b0/b1 forced 0)
        low2 = self._low_table(b[2:4], 2)  # products over b2..b3

        for name, code in OPCODES.items():
            b6, b5, b4 = code >> 6, (code >> 5) & 1, (code >> 4) & 1
            if not b6:
                flags[name] = hi[(b5, b4)] * low4[code & 0xF]
            elif not b5 and not b4:
                flags[name] = u32pre * low3[(code >> 1) & 0x7]
            elif not b5:
                flags[name] = e0 * low4[code & 0xF]
            else:
                flags[name] = e1 * self._sel(b[4], b4) * low2[(code >> 2) & 0x3]
        return flags

    def _build_next_ctrl(self, bn, e1n):
        """Next-row flags for END/REPEAT/RESPAN/HALT (prefix 111, degree 4)
        plus their sum (degree 2: e1'·b4')."""
        out = {}
        pre = e1n * bn[4]  # 111 prefix
        for name in ("END", "REPEAT", "RESPAN", "HALT"):
            code = OPCODES[name]
            v3, v2 = (code >> 3) & 1, (code >> 2) & 1
            out[name] = pre * self._sel(bn[3], v3) * self._sel(bn[2], v2)
        out["ANY"] = pre
        return out

    # -- composite flags -----------------------------------------------------

    def _composites(self):
        f, b = self.f, self.bits
        flg = self.flags
        # f_shr = (1-b6)·b5·b4 + f_u32split + f_push (degree 6)
        self.shift_right = (1 - b[6]) * b[5] * b[4] + flg["U32SPLIT"] + flg["PUSH"]
        # f_add3_madd = b6·(1-b5)·(1-b4)·b3·b2 (degree 5)
        add3_madd = self.u32_rc * b[3] * b[2]
        h5 = f.main(L.END_IS_LOOP)
        # f_shl = (1-b6)·b5·(1-b4) + add3_madd + split + repeat + end·h5 +
        #         dyn  (degree 5). DYNCALL is intentionally EXCLUDED
        # (op_flags/mod.rs:599-619): it left-shifts the stack but its depth
        # reset rides call_entry and its overflow pop uses the h5-stored
        # pointer (buses.py overflow mux) — including it here double-pops
        # the overflow table and forces b0' = 15 on DYNCALL rows whenever
        # the overflow table is non-empty.
        self.shift_left = (
            (1 - b[6]) * b[5] * (1 - b[4])
            + add3_madd
            + flg["SPLIT"]
            + flg["REPEAT"]
            + flg["END"] * h5
            + flg["DYN"]
        )
        # control flow flag (degree 4): 10101xx ∪ 111xxxx ∪ 1101xxx ∪ 1011x00
        e0, e1 = self.e0, self.e1
        self.control_flow = (
            e0 * (1 - b[3]) * b[2]
            + e1 * b[4]
            + e1 * (1 - b[4]) * b[3]
            + e0 * b[3] * (1 - b[1]) * (1 - b[0])
        )
        # call-entry flag: new execution context starts next row
        self.call_entry = flg["CALL"] + flg["SYSCALL"] + flg["DYNCALL"]
        self.imm = flg["PUSH"]
