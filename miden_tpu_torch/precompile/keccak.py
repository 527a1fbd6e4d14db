"""Keccak-256 precompile chiplet: bit-column round AIR (stage 2).

Proves deferred claims ``out = keccak256(a || b)`` for 64-byte messages
(two 32-byte words — the dominant ZK use-case: Merkle nodes, Ethereum
storage slots). Covers the role of the reference's Keccak round + sponge
chiplets (precompiles-prover/src/hash/keccak/{round,sponge}/) with a
deliberately different, TPU-first arithmetization:

* the reference decomposes lanes into bytes and routes every XOR/AND
  through a byte-pair lookup table committed as preprocessed columns
  (precompiles-prover/src/primitives/byte_pair_lut.rs) — a good fit for
  a CPU prover where trace width is expensive and lookups are cheap;
* here the state is **1600 boolean columns** plus 320 theta-D helper
  bits, one keccak-f round per row (32-row cycles: rounds at rows 0–23,
  output at row 24). On TPU the commit is row-parallel, so width is
  cheap, and boolean algebra keeps every constraint local — XOR/AND
  become degree-2/3 polynomial identities, rho/pi rotations are pure
  column re-indexing (free), and no extra LogUp bus traffic is needed.

Per 32-row cycle (one claim):

  row 0     state = padded message block (pad10*1 bits fixed by
            constraints; capacity zero); operand limbs a/b are linear
            bit-combinations wired to the Poseidon2 AIR for the claim's
            operand digests ha/hb (same wiring-bus pattern as the U256
            chiplet).
  rows 0-23 transition: A_{r+1} = iota(chi(pi(rho(theta(A_r))))), with
            theta routed through the D witness bits — D[x,z] is pinned
            by the degree-6 parity identity
            prod_{k=0..5}(S - d - 2k) = 0 over the 10-bit theta sum S,
            and iota folded into the *next* state (A' ^ rc = chi) to
            keep the worst transition at degree 8 (quotient chunks 7,
            within the blowup-8 budget).
  row 24    final state: digest limbs (first 4 lanes) wired to the
            Poseidon2 AIR for ho; claim message
            [KECCAK256_ID, ha, hb, ho] removed from the session claim
            bus (inserted by the chain AIR).

Claim/statement digests, the deferred-root fold, and the session facade
live in session.py; this module plugs into the same id-generic claim
machinery (claim id 4 = deferred.PID_KECCAK_MERGE).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..field import gl
from ..hash.keccak_host import ROTATIONS, ROUND_CONSTANTS, _rotl, keccak256
from ..stark.air import Air
from ..vm.constraints.buses import BUS_WIRING_IN, BUS_WIRING_OUT, Challenges, mux

from ..vm.deferred import PID_KECCAK_MERGE as KECCAK256_ID

_M64 = 0xFFFFFFFFFFFFFFFF
P = gl.P

# ---------------------------------------------------------------------------
# Column layout
# ---------------------------------------------------------------------------

K_ACT = 0
K_PERM = 1
K_HA = list(range(2, 14))
K_HB = list(range(14, 26))
K_HO = list(range(26, 38))
K_A0 = 38  # 1600 state bits: bit (x, y, z) at K_A0 + 64*(x + 5y) + z
K_D0 = K_A0 + 1600  # 320 theta-D bits: (x, z) at K_D0 + 64*x + z
KECCAK_WIDTH = K_D0 + 320

CYCLE = 32
ROUNDS = 24
OUT_ROW = ROUNDS  # row 24

# periodic column indices (period-32 patterns)
PZ_FIRST = 0
PZ_ROUND = 1
PZ_OUT = 2
PZ_END = 3
PZ_RC0 = 4  # 64 round-constant bit columns


def _abit(lane: int, z: int) -> int:
    return K_A0 + 64 * lane + z


def _dbit(x: int, z: int) -> int:
    return K_D0 + 64 * x + z


# ---------------------------------------------------------------------------
# Static index tables (rho/pi/chi wiring as pure column re-indexing)
# ---------------------------------------------------------------------------


def _build_tables():
    # B position (b_lane, z') <- post-theta position (a_lane, src_z):
    # b[y + 5*((2x+3y)%5)] = rotl(a'[x+5y], ROT[x][y])
    b_src_a = [0] * 1600  # A column of the pre-rotation bit
    b_src_d = [0] * 1600  # matching D column (theta: a' = a ^ d[x])
    for b_lane in range(25):
        y = b_lane % 5
        x = (3 * (b_lane // 5 - 3 * y)) % 5  # 2x + 3y = b_lane//5 (mod 5)
        r = ROTATIONS[x][y]
        a_lane = x + 5 * y
        for zp in range(64):
            src_z = (zp - r) % 64
            b_src_a[64 * b_lane + zp] = _abit(a_lane, src_z)
            b_src_d[64 * b_lane + zp] = _dbit(a_lane % 5, src_z)

    # chi: out(u, v, z) reads B at lanes (u, v), (u+1, v), (u+2, v)
    chi = {0: [], 1: [], 2: []}
    for lane in range(25):
        u, v = lane % 5, lane // 5
        for z in range(64):
            chi[0].append(64 * (u + 5 * v) + z)
            chi[1].append(64 * ((u + 1) % 5 + 5 * v) + z)
            chi[2].append(64 * ((u + 2) % 5 + 5 * v) + z)

    # theta parity: S(x, z) sums A[(x-1) mod 5, y, z] and
    # A[(x+1) mod 5, y, (z-1) mod 64] over y = 0..4
    parity = []  # 10 lists of 320 A-columns, in (x, z) order
    for t in range(10):
        lst = []
        for x in range(5):
            for z in range(64):
                if t < 5:
                    lst.append(_abit((x + 4) % 5 + 5 * t, z))
                else:
                    lst.append(_abit((x + 1) % 5 + 5 * (t - 5), (z + 63) % 64))
        parity.append(lst)
    return b_src_a, b_src_d, chi, parity


_B_SRC_A, _B_SRC_D, _CHI, _PARITY = _build_tables()


def _periodic_patterns():
    pats = [
        tuple(1 if r == 0 else 0 for r in range(CYCLE)),
        tuple(1 if r < ROUNDS else 0 for r in range(CYCLE)),
        tuple(1 if r == OUT_ROW else 0 for r in range(CYCLE)),
        tuple(1 if r == CYCLE - 1 else 0 for r in range(CYCLE)),
    ]
    for z in range(64):
        pats.append(
            tuple(
                (ROUND_CONSTANTS[r] >> z) & 1 if r < ROUNDS else 0
                for r in range(CYCLE)
            )
        )
    return tuple(pats)


# message/pad bit layout on row 0 (rate 136 bytes, pad 0x01 .. 0x80):
# bits 0..255 = a, 256..511 = b, bit 512 = 1, bits 513..1086 = 0,
# bit 1087 = 1, capacity bits 1088..1599 = 0
_PAD_ONE_BITS = (512, 1087)
_PAD_ZERO_BITS = tuple(
    [*range(513, 1087), *range(1088, 1600)]
)


def _limb_exprs(f, first_bit: int):
    """Eight 32-bit limb Exprs from 256 consecutive state bits."""
    limbs = []
    for i in range(8):
        e = f.main(K_A0 + first_bit + 32 * i)
        for t in range(1, 32):
            e = e + f.main(K_A0 + first_bit + 32 * i + t) * (1 << t)
        limbs.append(e)
    return limbs


def keccak_bus_columns(f):
    """4 fraction columns: ha/hb wiring (row 0), ho wiring (row 24), and
    the claim-bus removal (row 0)."""
    ch = Challenges(f)
    one = f.const(1)
    act = f.main(K_ACT)
    perm = f.main(K_PERM)
    pfirst = f.periodic(PZ_FIRST)
    pout = f.periodic(PZ_OUT)
    ha = [f.main(c) for c in K_HA]
    hb = [f.main(c) for c in K_HB]
    ho = [f.main(c) for c in K_HO]

    a_limbs = _limb_exprs(f, 0)
    b_limbs = _limb_exprs(f, 256)
    o_limbs = _limb_exprs(f, 0)  # row 24: state bits 0..255 = digest

    cols = []
    for k, (limbs, state, gate) in enumerate(
        (
            (a_limbs, ha, act * pfirst),
            (b_limbs, hb, act * pfirst),
            (o_limbs, ho, act * pout),
        )
    ):
        msg_in = ch.msg(BUS_WIRING_IN, [perm + k, *limbs, 2, 0, 0, 0])
        msg_out = ch.msg(BUS_WIRING_OUT, [perm + k, *state])
        cols.append(mux(one, [(gate, [(1, msg_in), (1, msg_out)])]))
    from .session import SBUS_CLAIM  # deferred: session imports us lazily

    claim = ch.msg(
        SBUS_CLAIM, [KECCAK256_ID, *ha[0:4], *hb[0:4], *ho[0:4]]
    )
    cols.append(mux(one, [(act * pfirst, [(-1, claim)])]))
    return cols


def _xor(a, b):
    return a + b - a * b * 2


class KeccakAir(Air):
    """keccak-f[1600] round AIR over boolean columns (32-row cycles)."""

    width = KECCAK_WIDTH
    aux_width = 1 + 4
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 8
    periodic_columns = _periodic_patterns()

    def eval(self, f) -> None:
        fam = []  # (kind, expr, labels)

        act = f.main(K_ACT)
        actn = f.main(K_ACT, 1)
        perm = f.main(K_PERM)
        permn = f.main(K_PERM, 1)
        pfirst = f.periodic(PZ_FIRST)
        pround = f.periodic(PZ_ROUND)
        pend = f.periodic(PZ_END)
        n_claims = f.public(4)
        n_u256 = f.public(5)

        # -- activity / schedule --
        fam.append(("zero", act * (act - 1), ["act/bool"]))
        fam.append(("trans", (1 - pend) * (actn - act), ["act/in_cycle"]))
        fam.append(("trans", (1 - act) * actn, ["act/monotone"]))
        fam.append(("first", act - 1, ["act/first"]))
        fam.append(
            ("first", perm - (n_claims + n_u256) * 3, ["perm/first"])
        )
        fam.append(("trans", (1 - pend) * (permn - perm), ["perm/in_cycle"]))
        fam.append(
            ("trans", pend * actn * (permn - perm - 3), ["perm/step"])
        )
        # ho is read by the claim removal (row 0) and the digest wiring
        # (row 24): pin it stable across the cycle so both see one value
        ho_now = f.main_many(K_HO)
        ho_nxt = f.main_many(K_HO, offset=1)
        fam.append(
            (
                "trans",
                (1 - pend) * (ho_nxt - ho_now),
                [f"ho/stable{i}" for i in range(12)],
            )
        )

        # -- booleanity --
        a_all = f.main_many(range(K_A0, K_A0 + 1600))
        fam.append(
            ("zero", a_all * (a_all - 1), [f"bool/a{i}" for i in range(1600)])
        )
        d_all = f.main_many(range(K_D0, K_D0 + 320))
        fam.append(
            ("zero", d_all * (d_all - 1), [f"bool/d{i}" for i in range(320)])
        )

        # -- theta-D parity: prod_{k=0..5}(S - d - 2k) = 0 on round rows --
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

        # -- round transition --
        def chi_expr(positions):
            """chi output over B positions (list of B indices)."""
            ops = []
            for slot in range(3):
                bp = [_CHI[slot][p] for p in positions]
                A = f.main_many([_B_SRC_A[j] for j in bp])
                D = f.main_many([_B_SRC_D[j] for j in bp])
                ops.append(_xor(A, D))  # rho/pi re-index of theta output
            b0, b1, b2 = ops
            return _xor(b0, (1 - b1) * b2)

        # lanes 1..24 (no iota): A_next = chi
        rest = list(range(64, 1600))
        nxt = f.main_many([K_A0 + i for i in rest], offset=1)
        fam.append(
            (
                "trans",
                act * pround * (nxt - chi_expr(rest)),
                [f"round/bit{i}" for i in rest],
            )
        )
        # lane 0 (iota folded into the next state: A_next ^ rc = chi)
        lane0 = list(range(64))
        nxt0 = f.main_many([K_A0 + i for i in lane0], offset=1)
        rcv = f.stack([f.periodic(PZ_RC0 + z) for z in range(64)])
        fam.append(
            (
                "trans",
                act * pround * (_xor(nxt0, rcv) - chi_expr(lane0)),
                [f"round/iota{i}" for i in lane0],
            )
        )

        # -- absorption: pad10*1 + zero capacity on cycle row 0 --
        pad_zero = f.main_many([K_A0 + b for b in _PAD_ZERO_BITS])
        fam.append(
            (
                "zero",
                pfirst * pad_zero,
                [f"absorb/zero{b}" for b in _PAD_ZERO_BITS],
            )
        )
        for b in _PAD_ONE_BITS:
            fam.append(
                (
                    "zero",
                    act * pfirst * (f.main(K_A0 + b) - 1),
                    [f"absorb/one{b}"],
                )
            )

        # -- buses --
        cols = keccak_bus_columns(f)
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
            self, main, publics, randomness, keccak_bus_columns
        )


# ---------------------------------------------------------------------------
# Claim + trace builder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Keccak256Claim:
    """Claim: out = keccak256(a || b) over little-endian 32-byte words."""

    a: int
    b: int

    def __post_init__(self):
        assert 0 <= self.a < (1 << 256) and 0 <= self.b < (1 << 256)

    @property
    def message(self) -> bytes:
        return self.a.to_bytes(32, "little") + self.b.to_bytes(32, "little")

    @cached_property  # read several times by the trace builders
    def out(self) -> int:
        return int.from_bytes(keccak256(self.message), "little")

    @property
    def id(self) -> int:
        return KECCAK256_ID


def _theta_d(a):
    c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
    return [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]


def _round(a, rc):
    """(d_lanes, next_state) for one keccak-f round (keccak_host.keccak_f
    with the theta-D witness exposed)."""
    d = _theta_d(a)
    a = [a[i] ^ d[i % 5] for i in range(25)]
    b = [0] * 25
    for x in range(5):
        for y in range(5):
            b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], ROTATIONS[x][y])
    a = [
        b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
        for i in range(25)
    ]
    a = [v & _M64 for v in a]
    a[0] ^= rc
    return d, a


_Z = np.arange(64, dtype=np.uint64)


def _write_bits(row, col0, lanes):
    for L, v in enumerate(lanes):
        row[col0 + 64 * L : col0 + 64 * L + 64] = (
            np.uint64(v) >> _Z
        ) & np.uint64(1)


def build_keccak_trace(claims, n_claims: int, n_u256: int, perm_states=None):
    """(rows, KECCAK_WIDTH) u64 trace for the keccak claims; appends the
    operand-hash permutation cycles to ``perm_states`` (list) when given."""
    from ..hash import poseidon2_host as hp

    nk = len(claims)
    n_cycles = max(1, 1 << (nk - 1).bit_length()) if nk else 1
    mat = np.zeros((CYCLE * n_cycles, KECCAK_WIDTH), dtype=np.uint64)
    perm0 = 3 * n_claims + 3 * n_u256
    mat[0, K_PERM] = perm0  # perm/first anchor even with zero claims

    for j, cl in enumerate(claims):
        base = CYCLE * j
        rows = mat[base : base + CYCLE]
        rows[:, K_ACT] = 1
        rows[:, K_PERM] = perm0 + 3 * j

        # absorb the single padded block (state starts at zero)
        padded = bytearray(cl.message) + bytearray(136 - 64)
        padded[64] ^= 0x01
        padded[135] ^= 0x80
        lanes = [0] * 25
        for i in range(17):
            lanes[i] = int.from_bytes(padded[8 * i : 8 * i + 8], "little")

        for r in range(ROUNDS):
            _write_bits(rows[r], K_A0, lanes)
            d, lanes = _round(lanes, ROUND_CONSTANTS[r])
            rows[r, K_D0 : K_D0 + 320] = np.concatenate(
                [((np.uint64(v) >> _Z) & np.uint64(1)) for v in d]
            )
        _write_bits(rows[OUT_ROW], K_A0, lanes)

        def limbs32(x):
            return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]

        sa = hp.permute([*limbs32(cl.a), 2, 0, 0, 0])
        sb = hp.permute([*limbs32(cl.b), 2, 0, 0, 0])
        so = hp.permute([*limbs32(cl.out), 2, 0, 0, 0])
        rows[0, K_HA], rows[0, K_HB] = sa, sb
        rows[:, K_HO] = so  # cycle-stable (claim removal + digest wiring)
        if perm_states is not None:
            perm_states.append(([*limbs32(cl.a), 2, 0, 0, 0], 1))
            perm_states.append(([*limbs32(cl.b), 2, 0, 0, 0], 1))
            perm_states.append(([*limbs32(cl.out), 2, 0, 0, 0], 1))
    return mat
