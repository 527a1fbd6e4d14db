"""secp256k1 EC session chiplets: complete group-law add claims on the
deferred-precompile session STARK.

Reference scope: ``precompiles-prover/src/ec/`` — the reference proves
EC statements with four chiplets (group table, point store, add, MSM)
that delegate 256-bit field math to uint MAC relations over byte-LUT
range checks. This module is the TPU-first redesign at claim
granularity:

- :class:`EcMacAir` — the **modular MAC chiplet**: one row proves
  ``a·b + m·(c·d) + e − f − g ≡ 0 (mod p_secp256k1)`` for 256-bit
  operands in 16-bit limbs (a 16×16 carry-save convolution like the
  session U256 mul rows), with a 17-limb quotient witness and every
  limb/carry range-checked against the shared 2^16 table. ``m`` is
  −1 or −3 (flag-selected), which is exactly enough to express every
  secp256k1 group-law identity in one row each — the analog of the
  reference's ``UintMul`` MAC trio (ec/mod.rs "curve-membership MAC").
- :class:`EcOpAir` — the **group-law chiplet**: one row per EC add
  claim carrying both operand points, the result, and the case
  witnesses (λ, Δ, Δ⁻¹, 2y, x²), with a complete-law case split
  (infinity-A / infinity-B / chord / tangent / negation) mirroring the
  reference's complete ``EcGroupAddAir`` (ec/add/mod.rs). Field math is
  delegated to the MAC chiplet over a LogUp bus; operand digests are
  re-derived by wiring two Poseidon2 absorbs per point to the shared
  permutation chiplet; the claim removes the session chain's
  ``[cid, ha, hb, ho]`` claim-bus message, so EC claims mix freely with
  u256/keccak claims in any order.

MAC messages carry seven 256-bit operands (57 felts) — wider than the
session's 16-element message bound — so the MAC bus uses a **long-form
encoding** with the bus prefix at β^64: a short-form message (prefix at
β^16) can never collide with a long-form one, because equality of the
two random linear combinations would force the long form's β^64
coefficient (bus+1 ≥ 1) to match the short form's zero.

Infinity is the (0, 0) sentinel ((0,0) is not on the curve), mirroring
the reference's ``is_pai`` flag + none-sentinel ptrs (ec/mod.rs).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..field import gl
from ..hash import poseidon2_host as hp
from ..stark.air import Air
from ..vm.constraints.buses import BUS_WIRING_IN, BUS_WIRING_OUT, Challenges, mux
from ..vm.deferred import (
    PID_EC_ADD,
    PID_EC_MUL,
    secp256k1_complete_add,
    secp256k1_scalar_mul,
)

P = gl.P

#: session-local MAC bus id (disjoint from wiring + SBUS_CLAIM/RANGE)
SBUS_MAC = 14

#: long-form message width bound (bus prefix at β^W_LONG)
W_LONG = 64

EC_PRIME = 2**256 - 2**32 - 977
_MASK16 = (1 << 16) - 1
_B23 = 1 << 23


def _limbs16(x: int) -> list[int]:
    return [(x >> (16 * i)) & _MASK16 for i in range(16)]


def _limbs32(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


_P16 = _limbs16(EC_PRIME)
#: constant limb coefficients of 8·2^256·p (the positivity offset)
_OFF = [0] * 16 + [8 * v for v in _P16]
_OFFSET_INT = 8 * (1 << 256) * EC_PRIME


class LongChallenges(Challenges):
    """β-power table for long-form (≤64-element) bus messages.

    ``D = α + (bus+1)·β^64 + Σ_{k<64} β^k·elem_k`` — collision-free
    against the 16-element short form (see module docstring)."""

    def __init__(self, f):
        alpha = f.rand(0)
        beta = f.rand(1)
        pows = [f.const(1), beta]
        for _ in range(W_LONG - 1):
            pows.append(pows[-1] * beta)
        self.beta = pows  # β^0 .. β^64
        self.alpha = alpha

    def msg(self, bus: int, elems):
        d = self.alpha + self.beta[W_LONG] * (bus + 1)
        for k, e in enumerate(elems):
            if isinstance(e, int) and e == 0:
                continue
            d = d + self.beta[k] * e
        return d


# ---------------------------------------------------------------------------
# Claims
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EcAddClaim:
    """Claim: out = a + b on secp256k1 (complete affine group law,
    (0, 0) = point at infinity)."""

    a: tuple
    b: tuple

    def __post_init__(self):
        for x, y in (self.a, self.b):
            assert 0 <= x < (1 << 256) and 0 <= y < (1 << 256)

    @cached_property  # read several times by the trace builders
    def out(self) -> tuple:
        return secp256k1_complete_add(self.a, self.b)

    @property
    def id(self) -> int:
        return PID_EC_ADD


@dataclass(frozen=True)
class EcMulClaim:
    """Claim: out = [a]·b on secp256k1 (a = 256-bit integer scalar,
    msb-first double-and-add over 256 steps; [0]·P = (0, 0)).

    The ECDSA-shaped claim: the reference proves these with the MSM
    chiplet stack (precompiles-prover/src/ec/msm/); here one claim row
    binds (k, P, R) digests and 512 forced step rows run the complete
    double-and-add chain, scalar bits re-packed into the claimed limb
    words at eight 32-bit boundaries."""

    a: int
    b: tuple

    def __post_init__(self):
        assert 0 <= self.a < (1 << 256)
        x, y = self.b
        assert 0 <= x < (1 << 256) and 0 <= y < (1 << 256)

    @cached_property  # read several times by the trace builders
    def out(self) -> tuple:
        return secp256k1_scalar_mul(self.a, self.b)

    @property
    def id(self) -> int:
        return PID_EC_MUL


def point_digest_states(pt) -> tuple:
    """(s1, s2) full Poseidon2 states of the two-chunk point-node sponge
    (deferred.ec_point_node digest = s2[0:4])."""
    x, y = pt
    s1 = hp.permute([*_limbs32(x), 2, 0, 0, 0])
    s2 = hp.permute([*_limbs32(y), *s1[8:12]])
    return s1, s2


def point_digest(pt) -> tuple:
    return tuple(point_digest_states(pt)[1][0:4])


# ---------------------------------------------------------------------------
# MAC chiplet
# ---------------------------------------------------------------------------

M_ACT = 0
M_M3 = 1
M_A = list(range(2, 18))
M_B = list(range(18, 34))
M_C = list(range(34, 50))
M_D = list(range(50, 66))
M_E = list(range(66, 82))
M_F = list(range(82, 98))
M_G = list(range(98, 114))
M_T = list(range(114, 131))  # 17 quotient limbs (top < 16)
M_CLO = list(range(131, 162))  # 31 carry-lo limbs (16-bit)
M_CHI = list(range(162, 193))  # 31 carry-hi limbs (< 256)
MAC_WIDTH = 193


def _packed32_cols(f, cols):
    limbs = [f.main(c) for c in cols]
    return [limbs[2 * j] + limbs[2 * j + 1] * (1 << 16) for j in range(8)]


def mac_message(f, long_ch):
    """The long-form MAC provide message, built from the row's limbs."""
    m3 = f.main(M_M3)
    elems = [m3]
    for block in (M_A, M_B, M_C, M_D, M_E, M_F, M_G):
        elems.extend(_packed32_cols(f, block))
    return long_ch.msg(SBUS_MAC, elems)


def mac_bus_columns(f):
    """1 provide column + 48 range-check columns (4 values each)."""
    from .session import SBUS_RANGE

    ch = Challenges(f)
    lch = LongChallenges(f)
    one = f.const(1)
    act = f.main(M_ACT)

    cols = [mux(one, [(act, [(1, mac_message(f, lch))])])]
    vals = [f.main(c) for c in (*M_A, *M_B, *M_C, *M_D, *M_E, *M_F, *M_G)]
    vals += [f.main(c) for c in M_T[0:16]]
    vals.append(f.main(M_T[16]) * 4096)  # top quotient limb < 16
    vals += [f.main(c) for c in M_CLO]
    vals += [f.main(c) * 256 for c in M_CHI]  # carry-hi < 256
    for g in range(0, len(vals), 4):
        fracs = [(1, ch.msg(SBUS_RANGE, [v])) for v in vals[g : g + 4]]
        cols.append(mux(one, [(act, fracs)]))
    return cols


class EcMacAir(Air):
    """Modular MAC rows: a·b + m·(c·d) + e − f − g ≡ 0 (mod p_secp).

    Integer identity proven limb-wise with signed offset carries:
    ``conv(a,b) − (1+2·m3)·conv(c,d) + e − f − g + 8·2^256·p = t·p``
    over ℤ, all limbs 16-bit range-checked, t a 17-limb quotient. The
    row-level analog of the reference's UintMul MAC relation
    (precompiles-prover/src/uint/mul/) with the secp256k1 modulus folded
    into the convolution instead of a wrapping 2^256 cut."""

    width = MAC_WIDTH
    aux_width = 1 + 49
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 8

    def eval(self, f) -> None:
        fam = {"zero": [], "trans": [], "first": [], "last": []}

        def A(kind, e, label):
            fam[kind].append((e, label))

        act = f.main(M_ACT)
        actn = f.main(M_ACT, 1)
        m3 = f.main(M_M3)
        a = [f.main(c) for c in M_A]
        b = [f.main(c) for c in M_B]
        c = [f.main(c_) for c_ in M_C]
        d = [f.main(c_) for c_ in M_D]
        e = [f.main(c_) for c_ in M_E]
        ff = [f.main(c_) for c_ in M_F]
        g = [f.main(c_) for c_ in M_G]
        t = [f.main(c_) for c_ in M_T]
        clo = [f.main(c_) for c_ in M_CLO]
        chi = [f.main(c_) for c_ in M_CHI]

        A("zero", act * (act - 1), "act/bool")
        A("trans", (1 - act) * actn, "act/monotone")
        A("last", act, "act/last_padding")
        A("zero", m3 * (m3 - 1), "m3/bool")
        A("zero", (1 - act) * m3, "m3/pad_zero")

        def conv(u, v, k):
            s = f.const(0)
            for i in range(max(0, k - len(v) + 1), min(k + 1, len(u))):
                s = s + u[i] * v[k - i]
            return s

        carries = [clo[i] + chi[i] * (1 << 16) for i in range(31)]
        mneg = 1 + m3 * 2  # |m| = 1 + 2·m3 (m = −|m|)
        for k in range(32):
            val = conv(a, b, k) - mneg * conv(c, d, k)
            if k < 16:
                val = val + e[k] - ff[k] - g[k]
            if _OFF[k]:
                val = val + _OFF[k]
            # t·p convolution (p limbs are constants)
            tp = f.const(0)
            for i in range(max(0, k - 15), min(k + 1, 17)):
                if _P16[k - i]:
                    tp = tp + t[i] * _P16[k - i]
            val = val - tp
            if k > 0:
                val = val + carries[k - 1] - _B23
            if k < 31:
                val = val - (carries[k] - _B23) * (1 << 16)
            A("zero", act * val, f"mac/limb{k}")

        cols = mac_bus_columns(f)
        acc = f.aux(0)
        accn = f.aux(0, 1)
        for k, (V, U) in enumerate(cols):
            av = f.aux(1 + k)
            A("trans", U * av - V, f"bus/frac{k}")
        total = f.aux(1)
        for k in range(1, len(cols)):
            total = total + f.aux(1 + k)
        A("trans", accn - acc - total, "bus/acc")
        A("first", acc, "bus/acc_first")
        A("last", acc - f.aux_value(0), "bus/acc_final")

        self.label_order = []
        for kind, sink in (
            ("zero", f.assert_zero_many),
            ("trans", f.assert_transition_many),
            ("first", f.assert_zero_first_row_many),
            ("last", f.assert_zero_last_row_many),
        ):
            items = fam[kind]
            if items:
                sink(f.stack([e_ for e_, _ in items]), f"family/{kind}")
                self.label_order.extend(label for _, label in items)

    def build_aux_trace(self, main, publics, aux_inputs, randomness):
        from ..vm.constraints.aux_numeric import build_device_aux

        return build_device_aux(
            self, main, publics, randomness, mac_bus_columns
        )


@dataclass(frozen=True)
class MacSpec:
    """One MAC row: a·b + m·(c·d) + e − f − g ≡ 0 (mod p), m = −1−2·m3."""

    a: int
    b: int
    c: int = 0
    d: int = 0
    e: int = 0
    f: int = 0
    g: int = 0
    m3: int = 0


def build_mac_rows(specs, counts=None) -> np.ndarray:
    """MAC trace rows (one per spec) + range-table multiplicities.

    The quotient t is a big-int division per spec; the limb convolutions
    and the carry chain run as numpy int64 arithmetic over all specs at
    once (|limb sums| < 2^40). The rows equal ``miden_tpu``'s per-spec
    builder."""
    n = len(specs)
    rows = 1 << max(1, n.bit_length())
    mat = np.zeros((rows, MAC_WIDTH), dtype=np.uint64)
    if n == 0:
        return mat
    mask = (1 << 256) - 1
    buf = bytearray()
    t_hi = np.zeros(n, dtype=np.int64)
    m3 = np.zeros(n, dtype=np.int64)
    for r, s in enumerate(specs):
        m = -(1 + 2 * s.m3)
        big = s.a * s.b + m * s.c * s.d + s.e - s.f - s.g + _OFFSET_INT
        t, rem = divmod(big, EC_PRIME)
        assert rem == 0, "MAC spec does not hold"
        assert 0 <= t < 16 << 256
        for v in (s.a, s.b, s.c, s.d, s.e, s.f, s.g, t):
            buf += (v & mask).to_bytes(32, "little")
        t_hi[r] = t >> 256
        m3[r] = s.m3
    limbs = np.frombuffer(bytes(buf), dtype="<u2").reshape(n, 8, 16).astype(np.int64)
    la, lb, lc, ld, le, lf, lg = (limbs[:, i] for i in range(7))
    lt = np.concatenate([limbs[:, 7], t_hi[:, None]], axis=1)  # (n, 17)
    m = -(1 + 2 * m3)[:, None]
    p16 = np.asarray(_P16, dtype=np.int64)

    # val[k] = conv(a, b)_k + m·conv(c, d)_k + (e − f − g)_k + OFF_k − conv(t, p)_k
    val = np.zeros((n, 31), dtype=np.int64)
    for i in range(16):
        val[:, i : i + 16] += la[:, i : i + 1] * lb + m * lc[:, i : i + 1] * ld
    val[:, :16] += le - lf - lg
    val += np.asarray(_OFF[:31], dtype=np.int64)
    for i in range(17):
        w = min(16, 31 - i)
        val[:, i : i + w] -= lt[:, i : i + 1] * p16[:w]

    clo = np.zeros((n, 31), dtype=np.int64)
    chi = np.zeros((n, 31), dtype=np.int64)
    carry = np.zeros(n, dtype=np.int64)
    for k in range(31):
        tot = val[:, k] + carry
        assert not (tot & _MASK16).any(), f"carry misalignment at limb {k}"
        carry = tot >> 16
        off = carry + _B23
        assert ((off >= 0) & (off < 1 << 24)).all()
        clo[:, k] = off & _MASK16
        chi[:, k] = off >> 16

    mat[:n, M_ACT] = 1
    mat[:n, M_M3] = m3
    for cols, v in zip((M_A, M_B, M_C, M_D, M_E, M_F, M_G, M_T, M_CLO, M_CHI),
                       (la, lb, lc, ld, le, lf, lg, lt, clo, chi)):
        mat[:n, cols] = v
    if counts is not None:
        vals = np.concatenate(
            [limbs.reshape(n, -1), lt[:, 16:] * 4096, clo, chi * 256], axis=1
        )
        counts += np.bincount(vals.ravel(), minlength=len(counts))
    return mat


# ---------------------------------------------------------------------------
# Group-law chiplet
# ---------------------------------------------------------------------------

E_ACT = 0
E_PERM = 1
E_CID = 2
E_FIA = 3
E_FIB = 4
E_FADD = 5
E_FDBL = 6
E_FNEG = 7
E_XA = list(range(8, 16))
E_YA = list(range(16, 24))
E_XB = list(range(24, 32))
E_YB = list(range(32, 40))
E_XR = list(range(40, 48))
E_YR = list(range(48, 56))
E_LAM = list(range(56, 64))
E_DLT = list(range(64, 72))
E_DLI = list(range(72, 80))
E_W2Y = list(range(80, 88))
E_UA = list(range(88, 96))
E_UB = list(range(96, 104))
E_SA1 = list(range(104, 116))
E_SA2 = list(range(116, 128))
E_SB1 = list(range(128, 140))
E_SB2 = list(range(140, 152))
E_SO1 = list(range(152, 164))
E_SO2 = list(range(164, 176))
# scalar-mul chain columns
E_CR = 176  # claim row flag
E_MUL = 177  # claim kind on claim rows: 0 = add, 1 = mul
E_CH = 178  # chain (double-and-add step) row flag
E_PAR = 179  # step parity: 0 = double row, 1 = add row
E_BIT = 180  # scalar bit consumed on add rows (msb-first)
E_FB = 181  # 32-bit word boundary (WC = 63)
E_FE = 182  # chain end (SC = 511)
E_SC = 183  # step counter 0..511 (range-forced)
E_WC = 184  # word-cycle counter 0..63 (range-forced)
E_KA = 185  # in-word scalar bit accumulator
E_KW = list(range(186, 194))  # scalar word register (shifts up at FB)
E_PX = list(range(194, 202))  # base point (copied down the chain)
E_PY = list(range(202, 210))
E_XO = list(range(210, 218))  # claimed result (checked at chain end)
E_YO = list(range(218, 226))
EC_WIDTH = 226

_ONE8 = [1] + [0] * 7
_SEVEN8 = [7] + [0] * 7
_ZERO8 = [0] * 8


def ec_bus_columns(f):
    """6 digest-wiring columns (one per Poseidon2 cycle; the first pair
    muxes between the add claim's point-A absorbs and the mul claim's
    single scalar absorb), the claim-bus removal, 4 flag-muxed
    MAC-consume columns, and 1 chain counter range column."""
    from .session import SBUS_CLAIM, SBUS_RANGE

    ch = Challenges(f)
    lch = LongChallenges(f)
    one = f.const(1)
    perm = f.main(E_PERM)
    cid = f.main(E_CID)
    cr = f.main(E_CR)
    cmul = f.main(E_MUL)
    chn_ = f.main(E_CH)
    fadd = f.main(E_FADD)
    fdbl = f.main(E_FDBL)
    fneg = f.main(E_FNEG)
    xa = [f.main(c) for c in E_XA]
    ya = [f.main(c) for c in E_YA]
    xb = [f.main(c) for c in E_XB]
    yb = [f.main(c) for c in E_YB]
    xr = [f.main(c) for c in E_XR]
    yr = [f.main(c) for c in E_YR]
    lam = [f.main(c) for c in E_LAM]
    dlt = [f.main(c) for c in E_DLT]
    dli = [f.main(c) for c in E_DLI]
    w2y = [f.main(c) for c in E_W2Y]
    ua = [f.main(c) for c in E_UA]
    ub = [f.main(c) for c in E_UB]
    kw = [f.main(c) for c in E_KW]

    cols = []
    # digest wiring: claim rows only. Slot A: two point absorbs for add
    # claims, one scalar absorb (output in SA2) for mul claims.
    sa1 = [f.main(c) for c in E_SA1]
    sa2 = [f.main(c) for c in E_SA2]
    in0 = ch.msg(BUS_WIRING_IN, [perm, *xa, 2, 0, 0, 0])
    out0 = ch.msg(BUS_WIRING_OUT, [perm, *sa1])
    in1 = ch.msg(
        BUS_WIRING_IN, [perm + 1, *ya, sa1[8], sa1[9], sa1[10], sa1[11]]
    )
    out1 = ch.msg(BUS_WIRING_OUT, [perm + 1, *sa2])
    in_k = ch.msg(BUS_WIRING_IN, [perm, *kw, 2, 0, 0, 0])
    out_k = ch.msg(BUS_WIRING_OUT, [perm, *sa2])
    cr_add = cr * (1 - cmul)
    cr_mul = cr * cmul
    cols.append(
        mux(
            one,
            [
                (cr_add, [(1, in0), (1, out0)]),
                (cr_mul, [(1, in_k), (1, out_k)]),
            ],
        )
    )
    cols.append(mux(one, [(cr_add, [(1, in1), (1, out1)])]))
    for k, (xc, yc, s1c, s2c) in enumerate(
        (
            (xb, yb, E_SB1, E_SB2),
            (xr, yr, E_SO1, E_SO2),
        )
    ):
        s1 = [f.main(c) for c in s1c]
        s2 = [f.main(c) for c in s2c]
        base = perm + 2 * (k + 1)
        i0 = ch.msg(BUS_WIRING_IN, [base, *xc, 2, 0, 0, 0])
        o0 = ch.msg(BUS_WIRING_OUT, [base, *s1])
        i1 = ch.msg(
            BUS_WIRING_IN, [base + 1, *yc, s1[8], s1[9], s1[10], s1[11]]
        )
        o1 = ch.msg(BUS_WIRING_OUT, [base + 1, *s2])
        cols.append(mux(one, [(cr, [(1, i0), (1, o0)])]))
        cols.append(mux(one, [(cr, [(1, i1), (1, o1)])]))
    sb2 = [f.main(c) for c in E_SB2]
    so2 = [f.main(c) for c in E_SO2]
    claim = ch.msg(SBUS_CLAIM, [cid, *sa2[0:4], *sb2[0:4], *so2[0:4]])
    cols.append(mux(one, [(cr, [(-1, claim)])]))

    def mac(m3, a, b, c=_ZERO8, d=_ZERO8, e=_ZERO8, fo=_ZERO8, g=_ZERO8):
        return lch.msg(SBUS_MAC, [m3, *a, *b, *c, *d, *e, *fo, *g])

    m_slope = mac(0, lam, xb, lam, xa, ya, yb)
    m_x3 = mac(0, lam, lam, xr, _ONE8, _ZERO8, xa, xb)
    m_y3 = mac(0, lam, xa, lam, xr, _ZERO8, ya, yr)
    m_dlt = mac(0, dlt, _ONE8, _ZERO8, _ZERO8, xa, xb)
    m_inv = mac(0, dlt, dli, _ZERO8, _ZERO8, _ZERO8, _ONE8)
    m_oc_au = mac(0, xa, xa, ua, _ONE8)
    m_oc_a = mac(0, ya, ya, ua, xa, _ZERO8, _SEVEN8)
    m_oc_bu = mac(0, xb, xb, ub, _ONE8)
    m_oc_b = mac(0, yb, yb, ub, xb, _ZERO8, _SEVEN8)
    m_w = mac(0, w2y, _ONE8, _ZERO8, _ZERO8, _ZERO8, ya, ya)
    m_slope_d = mac(1, lam, w2y, xa, xa)
    m_neg = mac(0, ya, _ONE8, _ZERO8, _ZERO8, yb)

    cols.append(
        mux(
            one,
            [
                (fadd, [(-1, m_slope), (-1, m_x3), (-1, m_y3)]),
                (fdbl, [(-1, m_w), (-1, m_slope_d), (-1, m_x3)]),
                (fneg, [(-1, m_neg)]),
            ],
        )
    )
    cols.append(
        mux(
            one,
            [
                (fadd, [(-1, m_dlt), (-1, m_inv)]),
                (fdbl, [(-1, m_y3)]),
            ],
        )
    )
    cols.append(
        mux(one, [(fadd + fdbl + fneg, [(-1, m_oc_au), (-1, m_oc_a)])])
    )
    cols.append(mux(one, [(fadd, [(-1, m_oc_bu), (-1, m_oc_b)])]))

    # chain counters: SC ≤ 511 and WC ≤ 63 (forces FE at 511, FB at 63)
    sc = f.main(E_SC)
    wc = f.main(E_WC)
    cols.append(
        mux(
            one,
            [
                (
                    chn_,
                    [
                        (1, ch.msg(SBUS_RANGE, [sc * 128])),
                        (1, ch.msg(SBUS_RANGE, [wc * 1024])),
                    ],
                )
            ],
        )
    )
    return cols


class EcOpAir(Air):
    """Complete secp256k1 group-law rows: add claims and scalar-mul
    double-and-add chains.

    Row kinds: **claim rows** (CR) bind operand digests through
    Poseidon2 wiring and remove the chain's claim-bus message — add
    claims are a claim row that is also a group-law op row; mul claim
    rows are pure binding rows followed by a forced 512-row chain.
    **Chain rows** (CH) alternate double (A=B=acc) and add
    (B = bit ? base : (0,0)) steps with the accumulator threaded
    through R→A transitions, starting at the infinity sentinel; scalar
    bits accumulate msb-first into a word register checked against the
    claimed limbs at eight 32-bit boundaries (WC/FB), and the final
    step's result must equal the claim row's bound output (FE).

    Each op row's case flags (one-hot): infinity-A → R = B;
    infinity-B → R = A; chord (x₁ ≠ x₂ proven by Δ·Δ⁻¹ ≡ 1); tangent
    (A = B limb-exact); negation (x equal, y₁+y₂ ≡ 0 → R = (0,0)).
    Finite cases consume on-curve MACs ("stored ⟹ on-curve",
    ec/mod.rs), so the (0,0) sentinel is unusable in a finite case.
    Mirrors precompiles-prover/src/ec/{add,msm}/ at claim granularity.
    """

    width = EC_WIDTH
    aux_width = 1 + 12
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 8

    def eval(self, f) -> None:
        fam = {"zero": [], "trans": [], "first": [], "last": []}

        def A(kind, e, label):
            fam[kind].append((e, label))

        act = f.main(E_ACT)
        actn = f.main(E_ACT, 1)
        perm = f.main(E_PERM)
        permn = f.main(E_PERM, 1)
        cid = f.main(E_CID)
        flags = [f.main(c) for c in (E_FIA, E_FIB, E_FADD, E_FDBL, E_FNEG)]
        fia, fib, fadd, fdbl, fneg = flags
        cr = f.main(E_CR)
        crn = f.main(E_CR, 1)
        cmul = f.main(E_MUL)
        chf = f.main(E_CH)
        chfn = f.main(E_CH, 1)
        par = f.main(E_PAR)
        parn = f.main(E_PAR, 1)
        bit = f.main(E_BIT)
        fb = f.main(E_FB)
        fe = f.main(E_FE)
        sc = f.main(E_SC)
        scn = f.main(E_SC, 1)
        wc = f.main(E_WC)
        wcn = f.main(E_WC, 1)
        ka = f.main(E_KA)
        kan = f.main(E_KA, 1)
        xa = [f.main(c) for c in E_XA]
        ya = [f.main(c) for c in E_YA]
        xan = [f.main(c, 1) for c in E_XA]
        yan = [f.main(c, 1) for c in E_YA]
        xb = [f.main(c) for c in E_XB]
        yb = [f.main(c) for c in E_YB]
        xr = [f.main(c) for c in E_XR]
        yr = [f.main(c) for c in E_YR]
        kw = [f.main(c) for c in E_KW]
        kwn = [f.main(c, 1) for c in E_KW]
        px = [f.main(c) for c in E_PX]
        py = [f.main(c) for c in E_PY]
        pxn = [f.main(c, 1) for c in E_PX]
        pyn = [f.main(c, 1) for c in E_PY]
        xo = [f.main(c) for c in E_XO]
        yo = [f.main(c) for c in E_YO]
        xon = [f.main(c, 1) for c in E_XO]
        yon = [f.main(c, 1) for c in E_YO]

        A("zero", act * (act - 1), "act/bool")
        A("trans", (1 - act) * actn, "act/monotone")
        A("last", act, "act/last_padding")
        for name, flag in (
            ("cr", cr),
            ("mul", cmul),
            ("ch", chf),
            ("par", par),
            ("bit", bit),
            ("fb", fb),
            ("fe", fe),
        ):
            A("zero", flag * (flag - 1), f"{name}/bool")
            A("zero", (1 - act) * flag, f"{name}/pad_zero")
        for j, fl in enumerate(flags):
            A("zero", fl * (fl - 1), f"flag/bool{j}")
            A("zero", (1 - act) * fl, f"flag/pad_zero{j}")
        # every active row is exactly one of claim / chain
        A("zero", act * (cr + chf - 1), "row/kind")
        A("zero", (1 - cr) * cmul, "mul/claim_only")
        # case flags: one-hot on op rows, absent on mul binding rows
        total_flags = flags[0]
        for fl in flags[1:]:
            total_flags = total_flags + fl
        A("zero", act * (total_flags - 1 + cr * cmul), "flag/one_hot")
        A("zero", act * cr * (cid - PID_EC_ADD - cmul), "id/claim")
        A("zero", chf * cid, "id/chain_zero")
        # fb/fe only on chain rows, at their forced counter values
        A("zero", (1 - chf) * fb, "fb/chain_only")
        A("zero", (1 - chf) * fe, "fe/chain_only")
        A("zero", fb * (wc - 63), "fb/at_63")
        A("zero", fe * (sc - 511), "fe/at_511")
        A("zero", chf * fb * (par - 1), "fb/add_row")
        # word boundary: completed word equals the register's top word
        A("zero", chf * fb * (ka + ka + bit - kw[7]), "kw/boundary")

        n_claims = f.public(4)
        n_u256 = f.public(5)
        n_km = f.public(6)
        A("first", perm - (n_claims + n_u256 + n_km) * 3, "perm/first")
        A("first", cr - 1, "first/claim_row")
        A("trans", actn * (permn - perm - 6 * crn), "perm/step")

        for i in range(8):
            A("zero", fia * xa[i], f"ia/xa{i}")
            A("zero", fia * ya[i], f"ia/ya{i}")
            A("zero", fia * (xr[i] - xb[i]), f"ia/xr{i}")
            A("zero", fia * (yr[i] - yb[i]), f"ia/yr{i}")
            A("zero", fib * xb[i], f"ib/xb{i}")
            A("zero", fib * yb[i], f"ib/yb{i}")
            A("zero", fib * (xr[i] - xa[i]), f"ib/xr{i}")
            A("zero", fib * (yr[i] - ya[i]), f"ib/yr{i}")
            A("zero", fdbl * (xa[i] - xb[i]), f"dbl/xeq{i}")
            A("zero", fdbl * (ya[i] - yb[i]), f"dbl/yeq{i}")
            A("zero", fneg * (xa[i] - xb[i]), f"neg/xeq{i}")
            A("zero", fneg * xr[i], f"neg/xr{i}")
            A("zero", fneg * yr[i], f"neg/yr{i}")
            # mul claim rows bind base point and claimed result copies
            A("zero", cr * cmul * (px[i] - xb[i]), f"mulcr/px{i}")
            A("zero", cr * cmul * (py[i] - yb[i]), f"mulcr/py{i}")
            A("zero", cr * cmul * (xo[i] - xr[i]), f"mulcr/xo{i}")
            A("zero", cr * cmul * (yo[i] - yr[i]), f"mulcr/yo{i}")
            # chain step operand pinning
            A("zero", chf * (1 - par) * (xb[i] - xa[i]), f"step/dbl_xb{i}")
            A("zero", chf * (1 - par) * (yb[i] - ya[i]), f"step/dbl_yb{i}")
            A("zero", chf * par * bit * (xb[i] - px[i]), f"step/add_xb{i}")
            A("zero", chf * par * bit * (yb[i] - py[i]), f"step/add_yb{i}")
            A("zero", chf * par * (1 - bit) * xb[i], f"step/addo_xb{i}")
            A("zero", chf * par * (1 - bit) * yb[i], f"step/addo_yb{i}")
            # chain end: final step result equals the claimed output
            A("zero", chf * fe * (xr[i] - xo[i]), f"end/xr{i}")
            A("zero", chf * fe * (yr[i] - yo[i]), f"end/yr{i}")

        # --- chain structure transitions ---
        crmul = cr * cmul
        cont = chf * (1 - fe)
        # chain rows appear only after a mul claim row or an unfinished
        # chain row; a mul claim row must start one; an unfinished chain
        # must continue
        A("trans", chfn * (1 - crmul - cont), "chain/provenance")
        A("trans", crmul * (1 - chfn), "chain/must_start")
        A("trans", cont * (1 - chfn), "chain/must_continue")
        # chain start state
        A("trans", crmul * scn, "start/sc")
        A("trans", crmul * parn, "start/par")
        A("trans", crmul * wcn, "start/wc")
        A("trans", crmul * kan, "start/ka")
        for i in range(8):
            A("trans", crmul * xan[i], f"start/xa{i}")
            A("trans", crmul * yan[i], f"start/ya{i}")
            A("trans", crmul * (kwn[i] - kw[i]), f"start/kw{i}")
        # chain continuation state
        A("trans", cont * (scn - sc - 1), "cont/sc")
        A("trans", cont * (parn - 1 + par), "cont/par")
        A("trans", cont * (wcn - (1 - fb) * (wc + 1)), "cont/wc")
        A(
            "trans",
            cont * (kan - (1 - fb) * (ka + par * (ka + bit))),
            "cont/ka",
        )
        A("trans", cont * (kwn[0] - (1 - fb) * kw[0]), "cont/kw0")
        for i in range(1, 8):
            A(
                "trans",
                cont * (kwn[i] - (1 - fb) * kw[i] - fb * kw[i - 1]),
                f"cont/kw{i}",
            )
        for i in range(8):
            A("trans", cont * (xan[i] - xr[i]), f"cont/acc_x{i}")
            A("trans", cont * (yan[i] - yr[i]), f"cont/acc_y{i}")
        # base point and claimed output copy down the whole chain
        carry = crmul + cont
        for i in range(8):
            A("trans", carry * (pxn[i] - px[i]), f"copy/px{i}")
            A("trans", carry * (pyn[i] - py[i]), f"copy/py{i}")
            A("trans", carry * (xon[i] - xo[i]), f"copy/xo{i}")
            A("trans", carry * (yon[i] - yo[i]), f"copy/yo{i}")

        cols = ec_bus_columns(f)
        acc = f.aux(0)
        accn = f.aux(0, 1)
        for k, (V, U) in enumerate(cols):
            av = f.aux(1 + k)
            A("trans", U * av - V, f"bus/frac{k}")
        total = f.aux(1)
        for k in range(1, len(cols)):
            total = total + f.aux(1 + k)
        A("trans", accn - acc - total, "bus/acc")
        A("first", acc, "bus/acc_first")
        A("last", acc - f.aux_value(0), "bus/acc_final")

        self.label_order = []
        for kind, sink in (
            ("zero", f.assert_zero_many),
            ("trans", f.assert_transition_many),
            ("first", f.assert_zero_first_row_many),
            ("last", f.assert_zero_last_row_many),
        ):
            items = fam[kind]
            if items:
                sink(f.stack([e for e, _ in items]), f"family/{kind}")
                self.label_order.extend(label for _, label in items)

    def build_aux_trace(self, main, publics, aux_inputs, randomness):
        from ..vm.constraints.aux_numeric import build_device_aux

        return build_device_aux(
            self, main, publics, randomness, ec_bus_columns
        )


# ---------------------------------------------------------------------------
# Trace builders
# ---------------------------------------------------------------------------


def _inv_mod_p(v: int) -> int:
    return pow(v, -1, EC_PRIME)


def ec_case_and_witnesses(p, q) -> tuple:
    """(flag_name, witnesses dict, mac specs) for one complete-add row;
    the host twin of the EcOpAir case split."""
    x1, y1 = p
    x2, y2 = q
    w = dict(lam=0, dlt=0, dli=0, w2y=0, ua=0, ub=0)
    if p == (0, 0):
        return "ia", w, []
    if q == (0, 0):
        return "ib", w, []
    specs = []
    w["ua"] = x1 * x1 % EC_PRIME
    oc_a = [
        MacSpec(a=x1, b=x1, c=w["ua"], d=1),
        MacSpec(a=y1, b=y1, c=w["ua"], d=x1, f=7),
    ]
    r = secp256k1_complete_add(p, q)
    x3, y3 = r
    if x1 == x2 and y1 == y2:
        w["w2y"] = 2 * y1 % EC_PRIME
        w["lam"] = 3 * x1 * x1 * _inv_mod_p(w["w2y"]) % EC_PRIME
        specs = [
            MacSpec(a=w["w2y"], b=1, f=y1, g=y1),
            MacSpec(a=w["lam"], b=w["w2y"], c=x1, d=x1, m3=1),
            MacSpec(a=w["lam"], b=w["lam"], c=x3, d=1, f=x1, g=x2),
            MacSpec(a=w["lam"], b=x1, c=w["lam"], d=x3, f=y1, g=y3),
            *oc_a,
        ]
        return "dbl", w, specs
    if x1 == x2:  # y2 = −y1: result infinity
        specs = [MacSpec(a=y1, b=1, e=y2), *oc_a]
        return "neg", w, specs
    w["ub"] = x2 * x2 % EC_PRIME
    w["dlt"] = (x2 - x1) % EC_PRIME
    w["dli"] = _inv_mod_p(w["dlt"])
    w["lam"] = (y2 - y1) * w["dli"] % EC_PRIME
    specs = [
        MacSpec(a=w["lam"], b=x2, c=w["lam"], d=x1, e=y1, f=y2),
        MacSpec(a=w["lam"], b=w["lam"], c=x3, d=1, f=x1, g=x2),
        MacSpec(a=w["lam"], b=x1, c=w["lam"], d=x3, f=y1, g=y3),
        MacSpec(a=w["dlt"], b=1, e=x1, f=x2),
        MacSpec(a=w["dlt"], b=w["dli"], f=1),
        *oc_a,
        MacSpec(a=x2, b=x2, c=w["ub"], d=1),
        MacSpec(a=y2, b=y2, c=w["ub"], d=x2, f=7),
    ]
    return "add", w, specs


_FLAG_COL = {
    "ia": E_FIA,
    "ib": E_FIB,
    "add": E_FADD,
    "dbl": E_FDBL,
    "neg": E_FNEG,
}

#: chain rows per scalar-mul claim (256 double rows + 256 add rows)
MUL_CHAIN_ROWS = 512


def _fill_op_row(row, a_pt, b_pt, r_pt, case, w):
    row[_FLAG_COL[case]] = 1
    row[E_XA], row[E_YA] = _limbs32(a_pt[0]), _limbs32(a_pt[1])
    row[E_XB], row[E_YB] = _limbs32(b_pt[0]), _limbs32(b_pt[1])
    row[E_XR], row[E_YR] = _limbs32(r_pt[0]), _limbs32(r_pt[1])
    row[E_LAM] = _limbs32(w["lam"])
    row[E_DLT] = _limbs32(w["dlt"])
    row[E_DLI] = _limbs32(w["dli"])
    row[E_W2Y] = _limbs32(w["w2y"])
    row[E_UA] = _limbs32(w["ua"])
    row[E_UB] = _limbs32(w["ub"])


def _claim_row_wiring(row, claim, perm_cycles):
    """Fills the digest-state columns and appends the claim's 6
    permutation cycles (mul claims: scalar absorb + 1 dummy)."""
    if isinstance(claim, EcMulClaim):
        ha_state = hp.permute([*_limbs32(claim.a), 2, 0, 0, 0])
        row[E_SA2] = ha_state
        perm_cycles.append(([*_limbs32(claim.a), 2, 0, 0, 0], 1))
        perm_cycles.append(([0] * 12, 0))  # unused slot-A second cycle
        pts = (claim.b, claim.out)
    else:
        s1, s2 = point_digest_states(claim.a)
        row[E_SA1], row[E_SA2] = s1, s2
        perm_cycles.append(([*_limbs32(claim.a[0]), 2, 0, 0, 0], 1))
        perm_cycles.append(([*_limbs32(claim.a[1]), *s1[8:12]], 1))
        pts = (claim.b, claim.out)
    for pt, (s1c, s2c) in zip(pts, ((E_SB1, E_SB2), (E_SO1, E_SO2))):
        s1, s2 = point_digest_states(pt)
        row[s1c] = s1
        row[s2c] = s2
        perm_cycles.append(([*_limbs32(pt[0]), 2, 0, 0, 0], 1))
        perm_cycles.append(([*_limbs32(pt[1]), *s1[8:12]], 1))


def build_ec_traces(ec_claims, perm_base: int, perm_cycles, counts=None):
    """(op_matrix, mac_matrix): EcOp claim row j consumes perm cycles
    perm_base + 6j (appended to ``perm_cycles``); mul claims emit 512
    chain rows each; group-law side conditions emit MAC rows."""
    n_rows = sum(
        1 + (MUL_CHAIN_ROWS if isinstance(c, EcMulClaim) else 0)
        for c in ec_claims
    )
    rows = 1 << max(1, n_rows.bit_length())
    if rows <= n_rows:
        rows <<= 1
    op = np.zeros((rows, EC_WIDTH), dtype=np.uint64)
    op[0, E_PERM] = perm_base  # perm/first anchor even with zero claims
    all_specs = []
    r = 0
    for j, cl in enumerate(ec_claims):
        perm_id = perm_base + 6 * j
        row = op[r]
        row[E_ACT] = 1
        row[E_CR] = 1
        row[E_PERM] = perm_id
        row[E_CID] = cl.id
        _claim_row_wiring(row, cl, perm_cycles)
        if isinstance(cl, EcAddClaim):
            case, w, specs = ec_case_and_witnesses(cl.a, cl.b)
            all_specs.extend(specs)
            _fill_op_row(row, cl.a, cl.b, cl.out, case, w)
            r += 1
            continue
        # mul claim: binding row + forced double-and-add chain
        base, out = cl.b, cl.out
        row[E_MUL] = 1
        row[E_XB], row[E_YB] = _limbs32(base[0]), _limbs32(base[1])
        row[E_XR], row[E_YR] = _limbs32(out[0]), _limbs32(out[1])
        row[E_PX], row[E_PY] = _limbs32(base[0]), _limbs32(base[1])
        row[E_XO], row[E_YO] = _limbs32(out[0]), _limbs32(out[1])
        row[E_KW] = _limbs32(cl.a)
        r += 1
        acc = (0, 0)
        kw = _limbs32(cl.a)
        ka = wc = 0
        for t in range(256):
            bit_i = (cl.a >> (255 - t)) & 1
            for par in (0, 1):
                srow = op[r]
                srow[E_ACT] = 1
                srow[E_CH] = 1
                srow[E_PERM] = perm_id
                srow[E_PAR] = par
                srow[E_SC] = 2 * t + par
                srow[E_WC] = wc
                srow[E_KA] = ka
                srow[E_KW] = kw
                srow[E_PX], srow[E_PY] = (
                    _limbs32(base[0]),
                    _limbs32(base[1]),
                )
                srow[E_XO], srow[E_YO] = (
                    _limbs32(out[0]),
                    _limbs32(out[1]),
                )
                if par == 0:
                    b_pt = acc
                else:
                    srow[E_BIT] = bit_i
                    b_pt = base if bit_i else (0, 0)
                r_pt = secp256k1_complete_add(acc, b_pt)
                case, w, specs = ec_case_and_witnesses(acc, b_pt)
                all_specs.extend(specs)
                _fill_op_row(srow, acc, b_pt, r_pt, case, w)
                fb = 1 if wc == 63 else 0
                srow[E_FB] = fb
                srow[E_FE] = 1 if 2 * t + par == 511 else 0
                if counts is not None:  # SC/WC range-bus multiplicities
                    counts[(2 * t + par) * 128] += 1
                    counts[wc * 1024] += 1
                if fb:
                    assert 2 * ka + bit_i == kw[7], "scalar word mismatch"
                    kw = [0] + kw[:-1]
                    ka, wc = 0, 0
                else:
                    wc += 1
                    if par:
                        ka = 2 * ka + bit_i
                acc = r_pt
                r += 1
        assert acc == out, "scalar-mul chain result mismatch"
    mac = build_mac_rows(all_specs, counts)
    return op, mac
