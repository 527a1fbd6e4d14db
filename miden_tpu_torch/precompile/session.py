"""Deferred-precompile session: the second STARK (u256 add/mul +
keccak256 merge + arbitrary-length keccak256).

Mirrors the reference's precompile VM architecture (a 13-chiplet AIR
stack proved with the same lifted-stark engine,
precompiles-prover/src/session/mod.rs:1-35) at stage-3 scope: the chain
/ u256 / range session AIRs + the keccak bit-column round AIRs
(keccak.py 64-byte merge, keccak_var.py arbitrary length) + the
canonical chunk-sponge AIR (keccak_var.SpongeAir) + the reused Poseidon2
permutation AIR, cross-linked by LogUp buses, proving that

1. the **deferred root** the main VM proof binds (the LOGDEFERRED
   AND-chain, vm/processor.py) is the fold of the claims' statement
   digests:  root_{k+1} = P([root_k, stmt_k, 1, 0, 0, 0])[0:4] — the
   canonical AND-node digest of the deferred DAG (vm/deferred.py,
   core/src/deferred/node.rs Tag::AND);
2. each **statement digest** is the canonical deferred-NODE digest of
   the claim's pair-list statement node
   (deferred.binop_statement_node): operand nodes are one-chunk CHUNKS
   nodes, ha/hb/ho = P([limbs8(x), 2, 0, 0, 0])[0:4], and the
   statement sponge threads its capacity:
   s1 = P([ha(4), hb(4), id, 0, 0, 0]),
   stmt = P([ho(4), 0⁴, s1[8:12]])[0:4];
3. each claim's **u256 arithmetic holds**: the U256 chiplet re-derives
   (a, b, out) from 16-bit limbs with boolean carries, re-hashes the
   operands (wiring to the same permutation cycles), and removes the
   claim-bus message [id, ha, hb, ho] the chain inserted;
4. every 16-bit limb is **range-checked** against the 2^16-row range
   table AIR (LogUp multiplicity bus).

AIR stack and buses:

  ChainAir     --[wiring in/out]-->  Poseidon2PermutationAir (reused
  U256Air      --[wiring in/out]-->    verbatim from the main VM)
  SpongeAir    --[wiring in/out]-->
  ChainAir     --[claim bus]------>  U256Air / KeccakAir (merge)
  KeccakVarAir --[chunk bus]------>  SpongeAir
  SpongeAir    --[kstmt bus]------>  ChainAir (join claims)
  U256Air      --[range bus]------>  RangeTableAir
  SpongeAir    --[range bus]------>  RangeTableAir (len/nb binding)

All aux accumulators sum to zero (MultiAir.eval_external), exactly the
main VM's LogUp-balance structure. Statement publics:
[root(4), n_claims, n_u256, n_kmerge]. Permutation cycle ids: chain
claim r (any kind, in root order) owns 3r..3r+2; u256 chiplet row j
owns 3n+3j (ha), +1 (hb), +2 (ho); merge-keccak cycle j owns
3(n+n_u256)+3j..; sponge row k owns 3(n+n_u256+n_kmerge)+k —
claim↔chiplet matching is order-free via the unordered claim/kstmt
buses, so claims may arrive in any (execution) order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import gl
from ..hash import poseidon2_host as hp
from ..stark.air import Air, MultiAir
from ..stark.params import MIDEN_PARAMS, PcsParams
from ..stark.prover import Statement
from ..transcript.challenger import DuplexChallenger
from ..utils.tracing import span
from ..vm import chiplets as VC
from ..vm.constraints.buses import BUS_WIRING_IN, BUS_WIRING_OUT, Challenges, mux
from ..vm.constraints.poseidon2_air import Poseidon2PermutationAir

#: session-local bus ids (disjoint from the wiring ids)
SBUS_CLAIM = 12
SBUS_RANGE = 13

#: Fiat–Shamir domain separator for the deferred-session protocol
SESSION_SEED = [0x6D69_6465, 0x6E2D_7470, 0x752D_6466, 0x0000_0001]

from ..vm.deferred import PID_U256_ADD as U256_ADD_ID
from ..vm.deferred import PID_U256_MUL as U256_MUL_ID

DEFERRED_EMPTY_ROOT = (0, 0, 0, 0)

_MASK16 = (1 << 16) - 1
P = gl.P


# ---------------------------------------------------------------------------
# Claims and digests (host arithmetic)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class U256AddClaim:
    """Claim: out = (a + b) mod 2^256 (wrapping u256 addition)."""

    a: int
    b: int

    def __post_init__(self):
        assert 0 <= self.a < (1 << 256) and 0 <= self.b < (1 << 256)

    @property
    def out(self) -> int:
        return (self.a + self.b) & ((1 << 256) - 1)

    @property
    def id(self) -> int:
        return U256_ADD_ID


@dataclass(frozen=True)
class U256MulClaim:
    """Claim: out = (a * b) mod 2^256 (wrapping u256 multiplication).

    Covers the reference's u256 mul relation
    (precompiles-prover/src/uint/mul/) on the shared U256 chiplet: mul
    rows carry the 16x16 limb convolution with two-part carries
    (16-bit lo + 5-bit hi), both range-checked via the 2^16 table."""

    a: int
    b: int

    def __post_init__(self):
        assert 0 <= self.a < (1 << 256) and 0 <= self.b < (1 << 256)

    @property
    def out(self) -> int:
        return (self.a * self.b) & ((1 << 256) - 1)

    @property
    def id(self) -> int:
        return U256_MUL_ID


def _limbs16(x: int) -> list[int]:
    return [(x >> (16 * i)) & _MASK16 for i in range(16)]


def _limbs32(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _operand_digest_state(x: int) -> list[int]:
    """Full permutation output of a u256 operand's CHUNKS-node sponge
    (deferred.u256_value_node digest = rate[0:4])."""
    return hp.permute([*_limbs32(x), 2, 0, 0, 0])


def claim_statement_digest(claim) -> tuple:
    """Canonical deferred-node digest of the claim's statement node:
    pair-list [(a, b), (out, TRUE)] for binop/merge claims
    (deferred.binop_statement_node), Join(msg_node, out_node) under tag
    [id, len, 0, 0] for arbitrary-length keccak claims
    (deferred.keccak_statement_node)."""
    from ..vm.deferred import PID_KECCAK256

    if claim.id == PID_KECCAK256:
        from ..vm.deferred import Node, keccak_message_chunks

        hm = Node.chunks_node(keccak_message_chunks(claim.message)).digest()
        ho = _operand_digest_state(claim.out)[0:4]
        stmt = hp.permute(
            [*hm, *ho, claim.id, len(claim.message), 0, 0]
        )[0:4]
        return tuple(stmt)
    from ..vm.deferred import PID_EC_ADD, PID_EC_MUL

    if claim.id in (PID_EC_ADD, PID_EC_MUL):
        from .ec import point_digest

        ha = (
            point_digest(claim.a)
            if claim.id == PID_EC_ADD
            else _operand_digest_state(claim.a)[0:4]
        )
        hb = point_digest(claim.b)
        ho = point_digest(claim.out)
    else:
        ha = _operand_digest_state(claim.a)[0:4]
        hb = _operand_digest_state(claim.b)[0:4]
        ho = _operand_digest_state(claim.out)[0:4]
    s1 = hp.permute([*ha, *hb, claim.id, 0, 0, 0])
    stmt = hp.permute([*ho, 0, 0, 0, 0, *s1[8:12]])[0:4]
    return tuple(stmt)


def fold_deferred_root(root, stmt) -> tuple:
    """One LOGDEFERRED AND-chain step (vm/processor.py LOGDEFERRED)."""
    return tuple(hp.permute([*root, *stmt, 1, 0, 0, 0])[0:4])


def deferred_root_for(claims) -> tuple:
    root = DEFERRED_EMPTY_ROOT
    for c in claims:
        root = fold_deferred_root(root, claim_statement_digest(c))
    return root


# ---------------------------------------------------------------------------
# Chain AIR
# ---------------------------------------------------------------------------

# column layout
CH_ACT = 0
CH_PERM = 1
CH_ID = 2
CH_PREV = list(range(3, 7))
CH_HA = list(range(7, 11))  # pair-list claims: ha; join claims: hm
CH_HB = list(range(11, 15))
CH_HO = list(range(15, 19))
CH_D1 = list(range(19, 31))  # pair-list: s1 full state (cap threaded)
CH_STMT = list(range(31, 43))
CH_FOLD = list(range(43, 55))
CH_KK = 55  # claim kind: 0 = pair-list (add/mul/merge), 1 = join (keccak)
CH_LEN = 56  # join claims: message byte length (tag arg)
CHAIN_WIDTH = 57


def chain_bus_columns(f):
    """Fraction columns: statement-sponge + fold wiring (3 permutation
    slots per claim), the claim-bus insertion for pair-list claims, and
    the kstmt-bus removal for join (arbitrary-length keccak) claims."""
    from .keccak_var import SBUS_KSTMT

    ch = Challenges(f)
    one = f.const(1)
    act = f.main(CH_ACT)
    perm = f.main(CH_PERM)
    cid = f.main(CH_ID)
    kk = f.main(CH_KK)
    length = f.main(CH_LEN)
    prev = [f.main(c) for c in CH_PREV]
    ha = [f.main(c) for c in CH_HA]
    hb = [f.main(c) for c in CH_HB]
    ho = [f.main(c) for c in CH_HO]
    d1 = [f.main(c) for c in CH_D1]
    stmt = [f.main(c) for c in CH_STMT]
    fold = [f.main(c) for c in CH_FOLD]

    # pair-list statement-node sponge, capacity threaded
    # (deferred.Node.digest):
    # absorb 1: s1 = P([ha, hb, cid, 0, 0, 0]) (tag word in capacity)
    # absorb 2: stmt = P([ho, 0^4, s1[8:12]])
    in_d1 = ch.msg(BUS_WIRING_IN, [perm, *ha, *hb, cid, 0, 0, 0])
    out_d1 = ch.msg(BUS_WIRING_OUT, [perm, *d1])
    in_st = ch.msg(
        BUS_WIRING_IN, [perm + 1, *ho, 0, 0, 0, 0, *[d1[i] for i in (8, 9, 10, 11)]]
    )
    out_st = ch.msg(BUS_WIRING_OUT, [perm + 1, *stmt])
    # join statement node (one absorb): stmt = P([hm, ho, cid, len, 0, 0])
    in_j = ch.msg(BUS_WIRING_IN, [perm, *ha, *ho, cid, length, 0, 0])
    out_j = ch.msg(BUS_WIRING_OUT, [perm, *stmt])
    # fold: both kinds
    in_fd = ch.msg(BUS_WIRING_IN, [perm + 2, *prev, *stmt[0:4], 1, 0, 0, 0])
    out_fd = ch.msg(BUS_WIRING_OUT, [perm + 2, *fold])
    claim = ch.msg(SBUS_CLAIM, [cid, *ha, *hb, *ho])
    kstmt = ch.msg(SBUS_KSTMT, [length, *ha, *ho])

    pl = act * (1 - kk)
    jn = act * kk
    cols = [
        mux(one, [(pl, [(1, in_d1), (1, out_d1)]), (jn, [(1, in_j), (1, out_j)])]),
        mux(one, [(pl, [(1, in_st), (1, out_st)])]),
        mux(one, [(act, [(1, in_fd), (1, out_fd)])]),
        mux(one, [(pl, [(1, claim)]), (jn, [(-1, kstmt)])]),
    ]
    return cols


class ChainAir(Air):
    """Deferred-root AND-chain + statement-digest assembly."""

    width = CHAIN_WIDTH
    aux_width = 1 + 4
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 8

    def eval(self, f) -> None:
        fam = {"zero": [], "trans": [], "first": [], "last": []}

        def A(kind, e, label):
            fam[kind].append((e, label))

        act = f.main(CH_ACT)
        actn = f.main(CH_ACT, 1)
        perm = f.main(CH_PERM)
        permn = f.main(CH_PERM, 1)
        kk = f.main(CH_KK)
        cid = f.main(CH_ID)
        prev = [f.main(c) for c in CH_PREV]
        prevn = [f.main(c, 1) for c in CH_PREV]
        fold = [f.main(c) for c in CH_FOLD]
        root = [f.public(i) for i in range(4)]

        # claim-kind selector: join rows carry the arbitrary-length
        # keccak id; pair-list rows one of the binop/merge ids
        A("zero", kk * (kk - 1), "kind/bool")
        A("zero", (1 - act) * kk, "kind/pad_zero")
        from ..vm.deferred import (
            PID_KECCAK256,
            PID_KECCAK_MERGE,
            PID_U256_MUL,
        )

        A("zero", kk * (cid - PID_KECCAK256), "kind/join_id")
        from ..vm.deferred import PID_EC_ADD, PID_EC_MUL

        A(
            "zero",
            act
            * (1 - kk)
            * (cid - U256_ADD_ID)
            * (cid - PID_KECCAK_MERGE)
            * (cid - PID_U256_MUL)
            * (cid - PID_EC_ADD)
            * (cid - PID_EC_MUL),
            "kind/pairlist_id",
        )

        # activity shape: boolean, monotone decreasing, last row inactive
        A("zero", act * (act - 1), "act/bool")
        A("trans", (1 - act) * actn, "act/monotone")
        A("last", act, "act/last_padding")
        A("first", act - 1, "act/first")  # ≥ 1 claim per session
        # chain continuity + perm id schedule
        A("first", perm, "perm/first")
        for i in range(4):
            A("first", prev[i], f"chain/prev0_{i}")
        A("trans", actn * (permn - perm - 3), "perm/step")
        for i in range(4):
            A("trans", actn * (prevn[i] - fold[i]), f"chain/link_{i}")
        # root binding on the active→inactive edge
        for i in range(4):
            A("trans", (act - actn) * (fold[i] - root[i]), f"chain/root_{i}")
        # padding rows carry zeros in perm/id so the schedule constraint
        # above can't be gamed by reviving activity (monotone covers it)

        # buses
        cols = chain_bus_columns(f)
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
            self, main, publics, randomness, chain_bus_columns
        )


# ---------------------------------------------------------------------------
# U256 AIR (stage 1: wrapping add)
# ---------------------------------------------------------------------------

U_ACT = 0
U_ID = 1
U_PERM = 2
U_A = list(range(3, 19))
U_B = list(range(19, 35))
U_O = list(range(35, 51))
U_C = list(range(51, 67))  # add: boolean carries; mul: 16-bit carry-lo
U_HA = list(range(67, 79))
U_HB = list(range(79, 91))
U_HO = list(range(91, 103))
U_MUL = 103  # op selector: 0 = add (id 3), 1 = mul (id 5)
U_CH = list(range(104, 120))  # mul carry-hi limbs (< 32, checked x 2048)
U256_WIDTH = 120


def _packed32(limbs):
    """16 × 16-bit limb Exprs → 8 × 32-bit felt combos."""
    return [limbs[2 * j] + limbs[2 * j + 1] * (1 << 16) for j in range(8)]


def u256_bus_columns(f):
    """6 wiring insertions (ha/hb/ho in+out, batched 2/col), the claim-bus
    removal, and 48 range-bus insertions batched 4 per column."""
    ch = Challenges(f)
    one = f.const(1)
    act = f.main(U_ACT)
    cid = f.main(U_ID)
    perm = f.main(U_PERM)
    a = [f.main(c) for c in U_A]
    b = [f.main(c) for c in U_B]
    o = [f.main(c) for c in U_O]
    ha = [f.main(c) for c in U_HA]
    hb = [f.main(c) for c in U_HB]
    ho = [f.main(c) for c in U_HO]

    cols = []
    for k, (limbs, state) in enumerate(((a, ha), (b, hb), (o, ho))):
        msg_in = ch.msg(BUS_WIRING_IN, [perm + k, *_packed32(limbs), 2, 0, 0, 0])
        msg_out = ch.msg(BUS_WIRING_OUT, [perm + k, *state])
        cols.append(mux(one, [(act, [(1, msg_in), (1, msg_out)])]))
    claim = ch.msg(
        SBUS_CLAIM, [cid, *ha[0:4], *hb[0:4], *ho[0:4]]
    )
    cols.append(mux(one, [(act, [(-1, claim)])]))
    for g in range(12):  # 48 limb range checks, 4 per fraction column
        limbs = (a + b + o)[4 * g : 4 * g + 4]
        fracs = [(1, ch.msg(SBUS_RANGE, [v])) for v in limbs]
        cols.append(mux(one, [(act, fracs)]))
    # mul-only range checks: carry-lo (16-bit) and carry-hi x 2048
    # (< 2^16 iff carry-hi < 32), 4 per fraction column, gated act*mul
    mul = f.main(U_MUL)
    clo = [f.main(c) for c in U_C]
    chi = [f.main(c) for c in U_CH]
    mvals = clo + [v * 2048 for v in chi]
    for g in range(8):
        fracs = [(1, ch.msg(SBUS_RANGE, [v])) for v in mvals[4 * g : 4 * g + 4]]
        cols.append(mux(one, [(act * mul, fracs)]))
    return cols


class U256Air(Air):
    """u256 wrapping add/mul over 16-bit limbs.

    Add rows (U_MUL = 0, id 3) use boolean ripple carries; mul rows
    (U_MUL = 1, id 5) constrain the 16x16 limb convolution
    ``conv_k + c_{k-1} = o_k + c_k * 2^16`` with two-part carries
    ``c_k = clo_k + chi_k * 2^16`` (clo 16-bit, chi < 32), matching the
    reference's uint mul relation (precompiles-prover/src/uint/mul/)
    with a carry-save arithmetization instead of byte LUTs."""

    width = U256_WIDTH
    aux_width = 1 + 24
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 8

    def eval(self, f) -> None:
        fam = {"zero": [], "trans": [], "first": [], "last": []}

        def A(kind, e, label):
            fam[kind].append((e, label))

        act = f.main(U_ACT)
        actn = f.main(U_ACT, 1)
        perm = f.main(U_PERM)
        permn = f.main(U_PERM, 1)
        cid = f.main(U_ID)
        a = [f.main(c) for c in U_A]
        b = [f.main(c) for c in U_B]
        o = [f.main(c) for c in U_O]
        c = [f.main(col) for col in U_C]
        n_claims = f.public(4)

        mul = f.main(U_MUL)
        ch_cols = [f.main(col) for col in U_CH]

        A("zero", act * (act - 1), "act/bool")
        A("trans", (1 - act) * actn, "act/monotone")
        A("last", act, "act/last_padding")
        # no act/first: all-keccak sessions leave this chiplet fully
        # padded (the claim bus still forces a removal per u256 claim)
        A("zero", mul * (mul - 1), "op/mul_bool")
        A("zero", (1 - act) * mul, "op/pad_mul_zero")
        # id = 3 (PID_U256_ADD) on add rows, 5 (PID_U256_MUL) on mul rows
        A("zero", act * (cid - U256_ADD_ID - 2 * mul), "id/u256_op")
        # permutation cycle schedule: first id = 3·n_claims, step 3
        A("first", perm - n_claims * 3, "perm/first")
        A("trans", actn * (permn - perm - 3), "perm/step")
        # add rows: limbwise addition with boolean carries
        for i in range(16):
            carry_in = c[i - 1] if i else f.const(0)
            A(
                "zero",
                act * (1 - mul)
                * (a[i] + b[i] + carry_in - o[i] - c[i] * (1 << 16)),
                f"add/limb{i}",
            )
            A("zero", act * (1 - mul) * c[i] * (c[i] - 1), f"add/carry{i}")
            A("zero", act * (1 - mul) * ch_cols[i], f"add/chi_zero{i}")
        # mul rows: carry-save convolution; carries range-bound via the
        # range bus (u256_bus_columns mul batches)
        for k in range(16):
            conv = f.const(0)
            for i in range(k + 1):
                j = k - i
                if j < 16:
                    conv = conv + a[i] * b[j]
            c_in = (
                c[k - 1] + ch_cols[k - 1] * (1 << 16) if k else f.const(0)
            )
            c_out = c[k] + ch_cols[k] * (1 << 16)
            A(
                "zero",
                act * mul * (conv + c_in - o[k] - c_out * (1 << 16)),
                f"mul/limb{k}",
            )

        cols = u256_bus_columns(f)
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
            self, main, publics, randomness, u256_bus_columns
        )


# ---------------------------------------------------------------------------
# 16-bit range table AIR
# ---------------------------------------------------------------------------

R_V = 0
R_M = 1
R_ACT = 2
RANGE_WIDTH = 3
RANGE_VALUES = 1 << 16
RANGE_ROWS = 1 << 17  # one padding half: the LogUp builders zero the last
# row's fraction (no transition window there), so value 65535 must not sit
# on the final row


def range_bus_columns(f):
    ch = Challenges(f)
    one = f.const(1)
    v = f.main(R_V)
    m = f.main(R_M)
    act = f.main(R_ACT)
    neg_m = m * (P - 1)
    return [mux(one, [(act, [(neg_m, ch.msg(SBUS_RANGE, [v]))])])]


class RangeTableAir(Air):
    """V = 0..65535 over the active prefix (structural), M = LogUp
    multiplicities, padding rows inactive."""

    width = RANGE_WIDTH
    aux_width = 2
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 8

    def eval(self, f) -> None:
        v = f.main(R_V)
        vn = f.main(R_V, 1)
        act = f.main(R_ACT)
        actn = f.main(R_ACT, 1)
        m = f.main(R_M)
        f.assert_zero(act * (act - 1), "range/act_bool")
        f.assert_transition((1 - act) * actn, "range/act_monotone")
        f.assert_zero_first_row(act - 1, "range/act_first")
        f.assert_zero_last_row(act, "range/act_last")
        f.assert_zero((1 - act) * m, "range/pad_mult_zero")
        f.assert_zero_first_row(v, "range/v0")
        f.assert_transition(actn * (vn - v - 1), "range/step")
        # the active→inactive edge pins the full table size
        f.assert_transition((act - actn) * (v - (RANGE_VALUES - 1)), "range/top")

        (wiring,) = range_bus_columns(f)
        acc = f.aux(0)
        accn = f.aux(0, 1)
        av = f.aux(1)
        V, U = wiring
        f.assert_transition(U * av - V, "bus/frac")
        f.assert_transition(accn - acc - av, "bus/acc")
        f.assert_zero_first_row(acc, "bus/acc_first")
        f.assert_zero_last_row(acc - f.aux_value(0), "bus/acc_final")

    def build_aux_trace(self, main, publics, aux_inputs, randomness):
        from ..vm.constraints.aux_numeric import build_device_aux

        return build_device_aux(
            self, main, publics, randomness, range_bus_columns
        )


class SessionPermAir(Poseidon2PermutationAir):
    num_public_values = 8


# ---------------------------------------------------------------------------
# Trace builders
# ---------------------------------------------------------------------------


def _pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


@dataclass
class SessionTraces:
    """Session trace matrices (None for a chiplet without claims) and the
    final deferred root."""

    chain: object
    u256: object
    rng: object
    perm: object
    root: tuple
    keccak: object = None  # merge-form bit-column chiplet
    kvar: object = None  # arbitrary-length keccak chiplet
    sponge: object = None  # canonical chunk-sponge chiplet
    ec_op: object = None  # secp256k1 group-law chiplet
    ec_mac: object = None  # secp256k1 modular MAC chiplet


def build_session_traces(claims) -> SessionTraces:
    """Builds every session chiplet trace + the final deferred root.
    Claims may mix U256AddClaim/U256MulClaim, Keccak256Claim (64-byte
    merge), and keccak_var.KeccakClaim (any length) in any (execution)
    order."""
    from .ec import EcAddClaim, EcMulClaim, point_digest
    from .keccak import Keccak256Claim, build_keccak_trace
    from .keccak_var import (
        KeccakClaim,
        build_keccak_var_trace,
        build_sponge_trace,
    )

    n = len(claims)
    assert n >= 1, "session requires at least one claim"
    u256_claims = [
        c for c in claims if isinstance(c, (U256AddClaim, U256MulClaim))
    ]
    keccak_claims = [c for c in claims if isinstance(c, Keccak256Claim)]
    arb_claims = [c for c in claims if isinstance(c, KeccakClaim)]
    ec_claims = [
        c for c in claims if isinstance(c, (EcAddClaim, EcMulClaim))
    ]
    nu = len(u256_claims)
    nk = len(keccak_claims)
    nec = len(ec_claims)

    rows = _pow2(n + 1)  # ≥ one padding row (act monotone drop in-window)
    urows = _pow2(nu + 1)
    chain = np.zeros((rows, CHAIN_WIDTH), dtype=np.uint64)
    u256 = np.zeros((urows, U256_WIDTH), dtype=np.uint64)
    u256[0, U_PERM] = 3 * n  # perm/first anchor even with zero u256 claims
    perm_cycles: list = [None] * (3 * n + 3 * nu + 3 * nk)
    DUMMY = ([0] * 12, 0)

    root = DEFERRED_EMPTY_ROOT
    for r, cl in enumerate(claims):
        row = chain[r]
        row[CH_ACT] = 1
        row[CH_PERM] = 3 * r
        row[CH_ID] = cl.id
        row[CH_PREV] = root
        if isinstance(cl, (EcAddClaim, EcMulClaim)):
            ha = (
                point_digest(cl.a)
                if isinstance(cl, EcAddClaim)
                else _operand_digest_state(cl.a)[0:4]
            )
            hb = point_digest(cl.b)
            ho = point_digest(cl.out)
            s_d1 = hp.permute([*ha, *hb, cl.id, 0, 0, 0])
            s_st = hp.permute([*ho, 0, 0, 0, 0, *s_d1[8:12]])
            s_fd = hp.permute([*root, *s_st[0:4], 1, 0, 0, 0])
            row[CH_HA], row[CH_HB], row[CH_HO] = ha, hb, ho
            row[CH_D1], row[CH_STMT], row[CH_FOLD] = s_d1, s_st, s_fd
            perm_cycles[3 * r] = ([*ha, *hb, cl.id, 0, 0, 0], 1)
            perm_cycles[3 * r + 1] = ([*ho, 0, 0, 0, 0, *s_d1[8:12]], 1)
            perm_cycles[3 * r + 2] = ([*root, *s_st[0:4], 1, 0, 0, 0], 1)
            root = tuple(s_fd[0:4])
            continue
        if isinstance(cl, KeccakClaim):
            from ..vm.deferred import Node, keccak_message_chunks

            hm = Node.chunks_node(keccak_message_chunks(cl.message)).digest()
            ho = _operand_digest_state(cl.out)[0:4]
            s_st = hp.permute([*hm, *ho, cl.id, len(cl.message), 0, 0])
            s_fd = hp.permute([*root, *s_st[0:4], 1, 0, 0, 0])
            row[CH_KK] = 1
            row[CH_LEN] = len(cl.message)
            row[CH_HA], row[CH_HO] = hm, ho
            row[CH_STMT], row[CH_FOLD] = s_st, s_fd
            perm_cycles[3 * r] = (
                [*hm, *ho, cl.id, len(cl.message), 0, 0],
                1,
            )
            perm_cycles[3 * r + 1] = DUMMY
            perm_cycles[3 * r + 2] = ([*root, *s_st[0:4], 1, 0, 0, 0], 1)
            root = tuple(s_fd[0:4])
            continue
        sa = _operand_digest_state(cl.a)
        sb = _operand_digest_state(cl.b)
        so = _operand_digest_state(cl.out)
        ha, hb, ho = sa[0:4], sb[0:4], so[0:4]
        s_d1 = hp.permute([*ha, *hb, cl.id, 0, 0, 0])
        s_st = hp.permute([*ho, 0, 0, 0, 0, *s_d1[8:12]])
        s_fd = hp.permute([*root, *s_st[0:4], 1, 0, 0, 0])

        row[CH_HA], row[CH_HB], row[CH_HO] = ha, hb, ho
        row[CH_D1], row[CH_STMT], row[CH_FOLD] = s_d1, s_st, s_fd
        perm_cycles[3 * r] = ([*ha, *hb, cl.id, 0, 0, 0], 1)
        perm_cycles[3 * r + 1] = ([*ho, 0, 0, 0, 0, *s_d1[8:12]], 1)
        perm_cycles[3 * r + 2] = ([*root, *s_st[0:4], 1, 0, 0, 0], 1)
        root = tuple(s_fd[0:4])

    for j, cl in enumerate(u256_claims):
        sa = _operand_digest_state(cl.a)
        sb = _operand_digest_state(cl.b)
        so = _operand_digest_state(cl.out)
        urow = u256[j]
        urow[U_ACT] = 1
        urow[U_ID] = cl.id
        urow[U_PERM] = 3 * n + 3 * j
        la, lb, lo = _limbs16(cl.a), _limbs16(cl.b), _limbs16(cl.out)
        urow[U_A], urow[U_B], urow[U_O] = la, lb, lo
        if isinstance(cl, U256MulClaim):
            urow[U_MUL] = 1
            carry = 0
            for k in range(16):
                conv = sum(
                    la[i] * lb[k - i] for i in range(k + 1) if k - i < 16
                )
                carry = (conv + carry - lo[k]) >> 16
                urow[U_C[k]] = carry & _MASK16
                urow[U_CH[k]] = carry >> 16
        else:
            carry = 0
            for i in range(16):
                s = la[i] + lb[i] + carry
                carry = s >> 16
                urow[U_C[i]] = carry
        urow[U_HA], urow[U_HB], urow[U_HO] = sa, sb, so
        perm_cycles[3 * n + 3 * j] = ([*_limbs32(cl.a), 2, 0, 0, 0], 1)
        perm_cycles[3 * n + 3 * j + 1] = ([*_limbs32(cl.b), 2, 0, 0, 0], 1)
        perm_cycles[3 * n + 3 * j + 2] = ([*_limbs32(cl.out), 2, 0, 0, 0], 1)

    keccak = None
    if keccak_claims:
        kperm: list = []
        keccak = build_keccak_trace(keccak_claims, n, nu, perm_states=kperm)
        perm_cycles[3 * n + 3 * nu : 3 * n + 3 * nu + 3 * nk] = kperm

    counts = np.zeros(RANGE_VALUES, dtype=np.int64)

    # EC region: 6 cycles per claim at 3·(n+nu+nk), before the sponge's
    ec_op = ec_mac = None
    if ec_claims:
        from .ec import build_ec_traces

        ec_op, ec_mac = build_ec_traces(
            ec_claims, 3 * (n + nu + nk), perm_cycles, counts
        )

    kvar = sponge = None
    if arb_claims:
        kvar = build_keccak_var_trace(arb_claims)
        sponge, _digests = build_sponge_trace(
            arb_claims, 3 * (n + nu + nk) + 6 * nec, perm_cycles
        )

    rng = np.zeros((RANGE_ROWS, RANGE_WIDTH), dtype=np.uint64)
    rng[:RANGE_VALUES, R_V] = np.arange(RANGE_VALUES, dtype=np.uint64)
    rng[:RANGE_VALUES, R_ACT] = 1
    for j, cl in enumerate(u256_claims):
        for v in (*_limbs16(cl.a), *_limbs16(cl.b), *_limbs16(cl.out)):
            counts[v] += 1
        if isinstance(cl, U256MulClaim):
            for k in range(16):
                counts[int(u256[j, U_C[k]])] += 1
                counts[int(u256[j, U_CH[k]]) * 2048] += 1
    for cl in arb_claims:  # sponge (len, nb) binding values
        counts[len(cl.message) - 136 * (cl.n_blocks - 1)] += 1
        counts[136 * cl.n_blocks - 1 - len(cl.message)] += 1
    rng[:RANGE_VALUES, R_M] = counts.astype(np.uint64)

    perm = VC.build_poseidon_trace(perm_cycles)
    return SessionTraces(
        chain, u256, rng, perm, root, keccak, kvar, sponge, ec_op, ec_mac
    )


class SessionMultiAir(MultiAir):
    def eval_external(self, randomness, aux_values, log_heights):
        total = (0, 0)
        for vals in aux_values:
            for v in vals:
                total = gl.ext_add(total, (int(v[0]), int(v[1])))
        return [total]


def _session_statement(
    root, n_claims: int, n_u256: int, n_kmerge: int, n_ec: int = 0
) -> Statement:
    from .ec import EcMacAir, EcOpAir
    from .keccak import KeccakAir
    from .keccak_var import KeccakVarAir, SpongeAir

    publics = [*[v % P for v in root], n_claims, n_u256, n_kmerge, n_ec]
    airs = [ChainAir(), U256Air(), RangeTableAir(), SessionPermAir()]
    if n_kmerge > 0:
        airs.append(KeccakAir())
    if n_claims - n_u256 - n_kmerge - n_ec > 0:  # arbitrary-length keccak
        airs.append(KeccakVarAir())
        airs.append(SpongeAir())
    if n_ec > 0:
        airs.append(EcOpAir())
        airs.append(EcMacAir())
    return Statement(SessionMultiAir(airs), publics)


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


@dataclass
class DeferredProof:
    """Session proof + the public session shape."""

    root: tuple
    n_claims: int
    stark: object  # stark.prover.Proof
    n_u256: int = -1  # -1 = legacy all-u256 session
    n_kmerge: int = -1  # -1 = legacy: every non-u256 claim is a merge
    n_ec: int = 0  # secp256k1 group-law claims

    def __post_init__(self):
        if self.n_u256 < 0:
            self.n_u256 = self.n_claims
        if self.n_kmerge < 0:
            self.n_kmerge = self.n_claims - self.n_u256


def prove_deferred_state(
    claims, params: PcsParams = MIDEN_PARAMS, device="cuda"
) -> DeferredProof:
    """Prove the deferred claims; the returned root must equal the main
    proof's bound deferred root (prove_deferred_state,
    precompiles-prover/src/lib.rs:35). The host builds the session traces
    and the proof runs on ``device`` (the card unless the caller asks for
    ``"cpu"``)."""
    from ..stark.prover import prove
    from .ec import EcAddClaim, EcMulClaim
    from .keccak import Keccak256Claim

    with span("build session traces"):
        tr = build_session_traces(claims)
    n = len(claims)
    nu = sum(1 for c in claims if isinstance(c, (U256AddClaim, U256MulClaim)))
    nk = sum(1 for c in claims if isinstance(c, Keccak256Claim))
    nec = sum(
        1 for c in claims if isinstance(c, (EcAddClaim, EcMulClaim))
    )
    statement = _session_statement(tr.root, n, nu, nk, nec)
    traces = [tr.chain, tr.u256, tr.rng, tr.perm]
    for extra in (tr.keccak, tr.kvar, tr.sponge, tr.ec_op, tr.ec_mac):
        if extra is not None:
            traces.append(extra)
    res = prove(
        params, statement, traces, DuplexChallenger(SESSION_SEED), device=device
    )
    return DeferredProof(
        root=tr.root,
        n_claims=n,
        stark=res.proof,
        n_u256=nu,
        n_kmerge=nk,
        n_ec=nec,
    )


def verify_deferred(
    proof: DeferredProof, expected_root, params: PcsParams = MIDEN_PARAMS
) -> None:
    """Check the session proof against the deferred root bound by a main
    proof (verify_deferred, precompiles-prover/src/session/prove.rs:371)."""
    from ..stark.verifier import VerificationError, verify

    if tuple(int(v) % P for v in proof.root) != tuple(
        int(v) % P for v in expected_root
    ):
        raise VerificationError("deferred root mismatch")
    if not 0 <= proof.n_u256 <= proof.n_claims:
        raise VerificationError("invalid session claim counts")
    if not 0 <= proof.n_kmerge <= proof.n_claims - proof.n_u256:
        raise VerificationError("invalid session claim counts")
    if not (
        0
        <= proof.n_ec
        <= proof.n_claims - proof.n_u256 - proof.n_kmerge
    ):
        raise VerificationError("invalid session claim counts")
    statement = _session_statement(
        proof.root, proof.n_claims, proof.n_u256, proof.n_kmerge, proof.n_ec
    )
    from ..transcript.challenger import TranscriptError

    try:
        verify(params, statement, proof.stark, DuplexChallenger(SESSION_SEED))
    except TranscriptError as e:
        raise VerificationError(str(e)) from e


# ---------------------------------------------------------------------------
# Deferred-DAG bridge
# ---------------------------------------------------------------------------


def claims_from_deferred_state(state) -> list:
    """Extracts session claims from a DeferredState's AND-chain in root
    order — the bridge from an execution's DAG witness
    (vm/processor.py) to the session prover. Raises DeferredError for
    statements no session chiplet covers."""
    from ..vm.deferred import (
        DeferredError,
        PID_EC_ADD,
        PID_EC_MUL,
        PID_KECCAK256,
        PID_KECCAK_MERGE,
        TAG_CHUNKS,
        TRUE_DIGEST,
        ec_point_value,
    )
    from .ec import EcAddClaim, EcMulClaim
    from .keccak import Keccak256Claim
    from .keccak_var import KeccakClaim

    def chunk_value(digest):
        node = state.get_node(tuple(digest))
        if node is None or node.tag != TAG_CHUNKS or len(node.chunks) != 1:
            raise DeferredError("operand is not a one-chunk value node")
        (chunk,) = node.chunks
        return sum(int(v) << (32 * i) for i, v in enumerate(chunk))

    stmts = []
    cur = tuple(state.root)
    while cur != TRUE_DIGEST:
        and_node = state.get_node(cur)
        if and_node is None or and_node.tag.id != 1:
            raise DeferredError("deferred root is not an AND-chain")
        prev, stmt = and_node.as_join()
        stmts.append(tuple(stmt))
        cur = tuple(prev)
    stmts.reverse()

    claims = []
    for sd in stmts:
        node = state.get_node(sd)
        if node is None:
            raise DeferredError("statement node missing from the DAG")
        pid = node.tag.id
        if pid in (U256_ADD_ID, U256_MUL_ID, PID_KECCAK_MERGE):
            (a_d, b_d), (out_d, _true) = node.as_pairs()
            a, b = chunk_value(a_d), chunk_value(b_d)
            cls = {
                U256_ADD_ID: U256AddClaim,
                U256_MUL_ID: U256MulClaim,
                PID_KECCAK_MERGE: Keccak256Claim,
            }[pid]
            claims.append(cls(a=a, b=b))
        elif pid == PID_KECCAK256:
            length = int(node.tag.args[0])
            msg_d, _out_d = node.as_join()
            msg_node = state.get_node(tuple(msg_d))
            if msg_node is None or msg_node.tag != TAG_CHUNKS:
                raise DeferredError("keccak message node missing")
            data = bytearray()
            for chunk in msg_node.chunks:
                for v in chunk:
                    data += int(v).to_bytes(4, "little")
            message = bytearray()
            for j in range(len(msg_node.chunks) // 5):
                message += data[160 * j : 160 * j + 136]
            claims.append(KeccakClaim(message=bytes(message[:length])))
        elif pid in (PID_EC_ADD, PID_EC_MUL):
            (a_d, b_d), (out_d, _true) = node.as_pairs()
            children = []
            for d in (a_d, b_d, out_d):
                child = state.get_node(tuple(d))
                if child is None:
                    raise DeferredError("EC operand node missing")
                children.append(child)
            if pid == PID_EC_ADD:
                claim = EcAddClaim(
                    a=ec_point_value(children[0]),
                    b=ec_point_value(children[1]),
                )
            else:
                claim = EcMulClaim(
                    a=chunk_value(a_d),
                    b=ec_point_value(children[1]),
                )
            if claim.out != ec_point_value(children[2]):
                raise DeferredError("EC statement does not hold")
            claims.append(claim)
        else:
            raise DeferredError(f"no session chiplet for precompile {pid}")
    return claims


def prove_deferred_state_dag(
    state, params: PcsParams = MIDEN_PARAMS, device="cuda"
) -> DeferredProof:
    """Prove the claims logged in a DeferredState; the session root
    equals the DAG root (and thus the main proof's bound root)."""
    proof = prove_deferred_state(
        claims_from_deferred_state(state), params, device=device
    )
    assert tuple(proof.root) == tuple(state.root), "DAG/session root split"
    return proof
