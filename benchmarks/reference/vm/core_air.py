"""Core VM AIR: decoder, system, stack, and range-checker constraints.

Constraint spec sources (implemented from the protocol docs, not the code):
  - docs/src/design/decoder/constraints.md  (decoder families)
  - docs/src/design/stack/{index,op_constraints,field_ops,stack_ops,
    u32_ops,io_ops,system_ops}.md            (stack families)
  - docs/src/design/range.md                 (range checker column)

This first stage covers every non-lookup constraint; the LogUp buses
(block stack/hash, op-group, overflow, range, chiplets) land in the aux
layer. Opcodes whose semantics are not yet constrained (crypto/stream
ops) are *forbidden*: their flags are constrained to zero, keeping the
implemented subset sound.

Public values layout: [stack_in(16), stack_out(16), program_hash(4),
deferred_root(4)].
"""

from __future__ import annotations

from ..air import Air
from . import layout as L
from .ops import OPCODES
from .op_flags import OpFlags

P2_16 = 1 << 16
P2_32 = 1 << 32
P2_48 = 1 << 48
U32M = P2_32 - 1

# opcodes whose flags would be forced to zero if not yet constraint-
# covered — every executable opcode now is, so the list is empty
FORBIDDEN_OPS = ()

# FRI fold-4 constants (docs crypto_ops.md §FRIE2F4; fri_ops/mod.rs):
# τ = 2^48 generates the order-4 subgroup of the Goldilocks multiplicative
# group; the fold uses τ^{-c} domain corrections
FRI_TAU_INV = 18446462594437873665
FRI_TAU2_INV = 18446744069414584320  # = -1
FRI_TAU3_INV = 281474976710656  # = 2^48

CTRL_OPS = (
    "JOIN", "SPLIT", "LOOP", "REPEAT", "SPAN", "RESPAN",
    "DYN", "DYNCALL", "CALL", "SYSCALL", "END", "HALT",
)


def _limb2(h, i):
    """h[i] + 2^16 · h[i+1]."""
    return h[i] + h[i + 1] * P2_16


def _limb4(h):
    return h[0] + h[1] * P2_16 + h[2] * P2_32 + h[3] * P2_48


def _horner_base(s, t, h):
    """tmp0/tmp1/acc' identities over u² = 7 (docs crypto_ops.md
    §HORNERBASE); helpers h = [α0, α1, tmp1_0, tmp1_1, tmp0_0, tmp0_1]."""
    a0, a1 = h[0], h[1]
    a2_0 = a0 * a0 + 7 * (a1 * a1)
    a2_1 = 2 * (a0 * a1)
    a3_0 = a0 * a2_0 + 7 * (a1 * a2_1)
    a3_1 = a0 * a2_1 + a1 * a2_0
    return [
        (s[14] * a2_0 + s[15] * (7 * a2_1) + s[0] * a0 + s[1] - h[4],
         "tmp0_0"),
        (s[14] * a2_1 + s[15] * a2_0 + s[0] * a1 - h[5], "tmp0_1"),
        (h[4] * a3_0 + h[5] * (7 * a3_1) + s[2] * a2_0 + s[3] * a0 + s[4]
         - h[2], "tmp1_0"),
        (h[4] * a3_1 + h[5] * a3_0 + s[2] * a2_1 + s[3] * a1 - h[3],
         "tmp1_1"),
        (h[2] * a3_0 + h[3] * (7 * a3_1) + s[5] * a2_0 + s[6] * a0 + s[7]
         - t[14], "acc0"),
        (h[2] * a3_1 + h[3] * a3_0 + s[5] * a2_1 + s[6] * a1 - t[15],
         "acc1"),
    ]


def _horner_ext(s, t, h):
    """tmp/acc' identities over u² = 7 (docs crypto_ops.md §HORNEREXT);
    helpers h = [α0, α1, k0, k1, tmp_0, tmp_1]."""
    a0, a1 = h[0], h[1]
    a2_0 = a0 * a0 + 7 * (a1 * a1)
    a2_1 = 2 * (a0 * a1)
    return [
        (s[14] * a2_0 + s[15] * (7 * a2_1) + s[0] * a0 + 7 * (s[1] * a1)
         + s[2] - h[4], "tmp_0"),
        (s[14] * a2_1 + s[15] * a2_0 + s[0] * a1 + s[1] * a0 + s[3] - h[5],
         "tmp_1"),
        (h[4] * a2_0 + h[5] * (7 * a2_1) + s[4] * a0 + 7 * (s[5] * a1)
         + s[6] - t[14], "acc0"),
        (h[4] * a2_1 + h[5] * a2_0 + s[4] * a1 + s[5] * a0 + s[7] - t[15],
         "acc1"),
    ]


def _frie2f4(s, t, h):
    """One factor-4 FRI fold (air/src/constraints/stack/crypto.rs:311
    enforce_frie2f4_constraints): inputs [q0, q2, q1, q3 | folded_pos,
    coset, poe, pe, α, layer_ptr]; the next row's s[0:8] are scratch
    degree-reduction intermediates; helpers h = [ev, ev², x, 1/x]."""
    # one-hot coset flags live in next-row scratch s'[4:7]
    cf1, cf2, cf3 = t[4], t[5], t[6]
    cf0 = 1 - cf1 - cf2 - cf3
    out = [(c * c - c, f"coset_flag{i}") for i, c in
           enumerate((cf0, cf1, cf2, cf3))]
    out.append((s[9] - (cf1 + 2 * cf2 + 3 * cf3), "coset_value"))
    # domain point x = poe·τ^{-coset}; 1/x witnessed in h[5]
    tau = cf0 + FRI_TAU_INV * cf1 + FRI_TAU2_INV * cf2 + FRI_TAU3_INV * cf3
    out.append((h[4] - s[10] * tau, "domain_point"))
    out.append((h[4] * h[5] - 1, "domain_point_inv"))
    # ev = α/x, es = ev²
    out.append((h[0] - s[13] * h[5], "ev0"))
    out.append((h[1] - s[14] * h[5], "ev1"))
    out.append((h[2] - (h[0] * h[0] + 7 * (h[1] * h[1])), "es0"))
    out.append((h[3] - 2 * (h[0] * h[1]), "es1"))

    # 2·fold2(a, b, ep) = (a + b) + (a − b)·ep over u² = 7
    def fold2_2x(a, b, ep, res, label):
        d0, d1 = a[0] - b[0], a[1] - b[1]
        out.append((
            a[0] + b[0] + d0 * ep[0] + 7 * (d1 * ep[1]) - 2 * res[0],
            f"{label}_0",
        ))
        out.append((
            a[1] + b[1] + d0 * ep[1] + d1 * ep[0] - 2 * res[1],
            f"{label}_1",
        ))

    ev = (h[0], h[1])
    ev_tau = (FRI_TAU_INV * h[0], FRI_TAU_INV * h[1])
    fold2_2x((s[0], s[1]), (s[2], s[3]), ev, (t[0], t[1]), "fold_mid0")
    fold2_2x((s[4], s[5]), (s[6], s[7]), ev_tau, (t[2], t[3]), "fold_mid1")
    fold2_2x((t[0], t[1]), (t[2], t[3]), (h[2], h[3]), (t[12], t[13]),
             "fold_result")
    # cross-layer consistency: pe = q_coset (stack order [q0, q2, q1, q3])
    out.append((
        s[11] - (s[0] * cf0 + s[4] * cf1 + s[2] * cf2 + s[6] * cf3), "pe0"
    ))
    out.append((
        s[12] - (s[1] * cf0 + s[5] * cf1 + s[3] * cf2 + s[7] * cf3), "pe1"
    ))
    # loop state for the next layer
    out.append((t[7] - s[10] * s[10], "poe_sq"))
    out.append((t[10] - t[7] * t[7], "poe_4th"))
    out.append((t[8] - (s[15] + 8), "layer_ptr"))
    out.append((t[9] - (s[15] + 8), "layer_ptr_copy"))
    out.append((t[14] - (s[15] + 8), "layer_ptr_fold"))
    out.append((t[11] - s[8], "folded_pos"))
    return out


def _validity(h, lo, hi):
    """(1 - m·(2^32-1-hi)) · lo — the field-element validity check
    (u32_ops.md §checking element validity); m is helper h[4]."""
    return (1 - h[4] * (U32M - hi)) * lo


# ---------------------------------------------------------------------------
# Per-op stack behavior table.
#
# no / left / right: positions d where the generic transition applies —
#   no:    s'_d = s_d
#   left:  s'_{d-1} = s_d   (d ≥ 1)
#   right: s'_{d+1} = s_d   (d ≤ 14)
# spec(s, t, h, env) -> [(expr, label)] op-specific constraints, each of
# degree ≤ 9 - flag_degree.
# ---------------------------------------------------------------------------


def _movup(n):
    return dict(right=range(0, n), no=range(n + 1, 16),
                spec=lambda s, t, h, v: [(t[0] - s[n], f"movup{n}")])


def _movdn(n):
    return dict(left=range(1, n + 1), no=range(n + 1, 16),
                spec=lambda s, t, h, v: [(t[n] - s[0], f"movdn{n}")])


def _dup(n):
    return dict(right=range(0, 15),
                spec=lambda s, t, h, v: [(t[0] - s[n], f"dup{n}")])


def _swapw_spec(off):
    def spec(s, t, h, v):
        out = []
        for i in range(4):
            out.append((t[i] - s[i + off], f"swapw@{i}"))
            out.append((t[i + off] - s[i], f"swapw@{i + off}"))
        return out

    return spec


def _u32_add_like(terms, label):
    def spec(s, t, h, v):
        total = terms(s)
        return [
            (total - (h[2] * P2_32 + _limb2(h, 0)), f"{label}/decomp"),
            (t[0] - _limb2(h, 0), f"{label}/lo"),
            (t[1] - h[2], f"{label}/carry"),
            (h[3], f"{label}/h3"),
        ]

    return spec


def _u32_mul_like(terms, label):
    def spec(s, t, h, v):
        total = terms(s)
        return [
            (total - _limb4(h), f"{label}/decomp"),
            (t[0] - _limb2(h, 0), f"{label}/lo"),
            (t[1] - _limb2(h, 2), f"{label}/hi"),
            (_validity(h, _limb2(h, 0), _limb2(h, 2)), f"{label}/valid"),
        ]

    return spec


STACK_SPEC: dict = {
    "NOOP": dict(no=range(0, 16)),
    "EQZ": dict(no=range(1, 16), spec=lambda s, t, h, v: [
        (s[0] * t[0], "eqz/zero"),
        (t[0] - (1 - s[0] * h[0]), "eqz/inv"),
    ]),
    "NEG": dict(no=range(1, 16), spec=lambda s, t, h, v: [(t[0] + s[0], "neg")]),
    "INV": dict(no=range(1, 16), spec=lambda s, t, h, v: [(t[0] * s[0] - 1, "inv")]),
    "INCR": dict(no=range(1, 16), spec=lambda s, t, h, v: [(t[0] - s[0] - 1, "incr")]),
    "NOT": dict(no=range(1, 16), spec=lambda s, t, h, v: [
        (s[0] * s[0] - s[0], "not/bin"),
        (t[0] - (1 - s[0]), "not"),
    ]),
    "MLOAD": dict(no=range(1, 16)),  # t0 bound by the memory chiplet bus
    "SWAP": dict(no=range(2, 16), spec=lambda s, t, h, v: [
        (t[0] - s[1], "swap/0"), (t[1] - s[0], "swap/1"),
    ]),
    "CALLER": dict(no=range(4, 16), spec=lambda s, t, h, v: [
        (t[i] - v["fn"][i], f"caller/{i}") for i in range(4)
    ]),
    "MOVUP2": _movup(2), "MOVDN2": _movdn(2),
    "MOVUP3": _movup(3), "MOVDN3": _movdn(3),
    "ADVPOPW": dict(no=range(4, 16)),
    "EXPACC": dict(no=range(4, 16), spec=lambda s, t, h, v: [
        (t[0] * t[0] - t[0], "expacc/bit"),
        (t[1] - s[1] * s[1], "expacc/base"),
        (h[0] - (1 + t[0] * (s[1] - 1)), "expacc/update"),
        (t[2] - s[2] * h[0], "expacc/acc"),
        (s[3] - (t[3] + t[3] + t[0]), "expacc/exp"),
    ]),
    "MOVUP4": _movup(4), "MOVDN4": _movdn(4),
    "MOVUP5": _movup(5), "MOVDN5": _movdn(5),
    "MOVUP6": _movup(6), "MOVDN6": _movdn(6),
    "MOVUP7": _movup(7), "MOVDN7": _movdn(7),
    "SWAPW": dict(no=range(8, 16), spec=_swapw_spec(4)),
    # s0/s1 unchanged via spec (not routing) to match the reference route
    # table (stack_route_tests.rs:121-125: EXT2MUL no-shifts 4.. only)
    "EXT2MUL": dict(no=range(4, 16), spec=lambda s, t, h, v: [
        (t[0] - s[0], "ext2mul/copy0"),
        (t[1] - s[1], "ext2mul/copy1"),
        (t[2] - (s[2] * s[0] + 7 * s[3] * s[1]), "ext2mul/c0"),
        (t[3] - (s[2] * s[1] + s[3] * s[0]), "ext2mul/c1"),
    ]),
    "MOVUP8": _movup(8), "MOVDN8": _movdn(8),
    "SWAPW2": dict(no=[*range(4, 8), *range(12, 16)], spec=_swapw_spec(8)),
    "SWAPW3": dict(no=range(4, 12), spec=_swapw_spec(12)),
    "SWAPDW": dict(spec=lambda s, t, h, v: [
        c for i in range(8)
        for c in ((t[i] - s[i + 8], f"swapdw/{i}"), (t[i + 8] - s[i], f"swapdw/{i + 8}"))
    ]),
    "EMIT": dict(no=range(0, 16)),
    # 12-lane state in/out via the hasher chiplet bus; helper[0] = the
    # controller address (crypto_ops.md HPERM)
    "HPERM": dict(no=range(12, 16)),
    # [V, depth, index, R, ...] unchanged; the path opening is enforced by
    # the MP_VERIFY / RETURN_HASH chiplet-bus pair (crypto_ops.md MPVERIFY)
    "MPVERIFY": dict(no=range(0, 16)),
    # [V_old, depth, index, R_old, V_new, ...] → [R_new, depth, index,
    # R_old, V_new, ...]; both legs + sibling reuse enforced by the
    # chiplet/sibling buses (crypto_ops.md MRUPDATE)
    "MRUPDATE": dict(no=range(4, 16)),
    # 8 Horner steps over base coefficients (crypto_ops.md §HORNERBASE):
    # α = (h0, h1) bound by the memory bus; tmp0 = (h4, h5) and
    # tmp1 = (h2, h3) are degree-reduction witnesses
    "HORNERBASE": dict(no=range(0, 14), spec=lambda s, t, h, v: _horner_base(s, t, h)),
    # 4 Horner steps over extension coefficients (crypto_ops.md
    # §HORNEREXT): α word = (h0..h3), tmp = (h4, h5)
    "HORNEREXT": dict(no=range(0, 14), spec=lambda s, t, h, v: _horner_ext(s, t, h)),
    # factor-4 FRI fold; the opcode sits in the left-shift group so depth
    # and overflow bookkeeping ride the composite shift flag
    "FRIE2F4": dict(spec=lambda s, t, h, v: _frie2f4(s, t, h)),
    # [ptr, n_read, n_eval, ...] unchanged; the whole circuit evaluation
    # is delegated to the ACE chiplet via the ACE_INIT bus message
    # (crypto_ops.md §EVALCIRCUIT, chiplets/ace.md)
    "EVALCIRCUIT": dict(no=range(0, 16)),
    # deferred-root fold: 12-lane hasher output on t[0:12] (bus-bound),
    # root chain threaded through the deferred bus (crypto_ops.md
    # §LOGDEFERRED)
    "LOGDEFERRED": dict(no=range(12, 16)),
    # keystream add: ciphertext = plaintext + rate, bound through the
    # memory bus reads/writes; both stream pointers advance by 8
    # (crypto_ops.md §CRYPTOSTREAM)
    "CRYPTOSTREAM": dict(no=(8, 9, 10, 11, 14, 15), spec=lambda s, t, h, v: [
        (t[12] - (s[12] + 8), "src_ptr"),
        (t[13] - (s[13] + 8), "dst_ptr"),
    ]),
    # -- left-shift group ---------------------------------------------------
    "ASSERT": dict(left=range(1, 16), spec=lambda s, t, h, v: [(s[0] - 1, "assert")]),
    "EQ": dict(left=range(2, 16), spec=lambda s, t, h, v: [
        ((s[0] - s[1]) * t[0], "eq/zero"),
        (t[0] - (1 - (s[0] - s[1]) * h[0]), "eq/inv"),
    ]),
    "ADD": dict(left=range(2, 16), spec=lambda s, t, h, v: [(t[0] - (s[0] + s[1]), "add")]),
    "MUL": dict(left=range(2, 16), spec=lambda s, t, h, v: [(t[0] - s[0] * s[1], "mul")]),
    "AND": dict(left=range(2, 16), spec=lambda s, t, h, v: [
        (s[0] * s[0] - s[0], "and/bin0"),
        (s[1] * s[1] - s[1], "and/bin1"),
        (t[0] - s[0] * s[1], "and"),
    ]),
    "OR": dict(left=range(2, 16), spec=lambda s, t, h, v: [
        (s[0] * s[0] - s[0], "or/bin0"),
        (s[1] * s[1] - s[1], "or/bin1"),
        (t[0] - (s[0] + s[1] - s[0] * s[1]), "or"),
    ]),
    "U32AND": dict(left=range(2, 16)),  # t0 bound by the bitwise chiplet bus
    "U32XOR": dict(left=range(2, 16)),
    "DROP": dict(left=range(1, 16)),
    "CSWAP": dict(left=range(3, 16), spec=lambda s, t, h, v: [
        (s[0] * s[0] - s[0], "cswap/bin"),
        (t[0] - (s[0] * s[2] + (1 - s[0]) * s[1]), "cswap/0"),
        (t[1] - (s[0] * s[1] + (1 - s[0]) * s[2]), "cswap/1"),
    ]),
    "CSWAPW": dict(left=range(9, 16), spec=lambda s, t, h, v: [
        (s[0] * s[0] - s[0], "cswapw/bin"),
        *[
            c for i in range(4) for c in (
                (t[i] - (s[0] * s[i + 5] + (1 - s[0]) * s[i + 1]), f"cswapw/{i}"),
                (t[i + 4] - (s[0] * s[i + 1] + (1 - s[0]) * s[i + 5]), f"cswapw/{i + 4}"),
            )
        ],
    ]),
    "MLOADW": dict(left=range(5, 16)),  # t0..t3 bound by the memory bus
    "MSTORE": dict(left=range(1, 16)),
    "MSTOREW": dict(left=range(1, 16)),
    # t0..t7 bound by the memory bus; s12 advances by 8 (io_ops.md MSTREAM/PIPE)
    "MSTREAM": dict(no=[8, 9, 10, 11, 13, 14, 15], spec=lambda s, t, h, v: [
        (t[12] - s[12] - 8, "mstream/fmp"),
    ]),
    "PIPE": dict(no=[8, 9, 10, 11, 13, 14, 15], spec=lambda s, t, h, v: [
        (t[12] - s[12] - 8, "pipe/fmp"),
    ]),
    # -- right-shift group --------------------------------------------------
    "PAD": dict(right=range(0, 15), spec=lambda s, t, h, v: [(t[0], "pad")]),
    "DUP0": _dup(0), "DUP1": _dup(1), "DUP2": _dup(2), "DUP3": _dup(3),
    "DUP4": _dup(4), "DUP5": _dup(5), "DUP6": _dup(6), "DUP7": _dup(7),
    "DUP9": _dup(9), "DUP11": _dup(11), "DUP13": _dup(13), "DUP15": _dup(15),
    "ADVPOP": dict(right=range(0, 15)),
    "SDEPTH": dict(right=range(0, 15), spec=lambda s, t, h, v: [
        (t[0] - v["b0"], "sdepth"),
    ]),
    "CLK": dict(right=range(0, 15), spec=lambda s, t, h, v: [(t[0] - v["clk"], "clk")]),
    # -- u32 group (flag degree 6, constraints ≤ 3) -------------------------
    "U32ADD": dict(no=range(2, 16), spec=_u32_add_like(lambda s: s[0] + s[1], "u32add")),
    "U32SUB": dict(no=range(2, 16), spec=lambda s, t, h, v: [
        (s[1] - (s[0] + t[1] - t[0] * P2_32), "u32sub/eq"),
        (t[0] * t[0] - t[0], "u32sub/borrow"),
        (t[1] - _limb2(h, 0), "u32sub/limbs"),
        (h[2], "u32sub/h2"),
        (h[3], "u32sub/h3"),
    ]),
    "U32MUL": dict(no=range(2, 16), spec=_u32_mul_like(lambda s: s[0] * s[1], "u32mul")),
    "U32DIV": dict(no=range(2, 16), spec=lambda s, t, h, v: [
        (s[1] - (s[0] * t[1] + t[0]), "u32div/eq"),
        ((s[1] - t[1]) - _limb2(h, 0), "u32div/qbound"),
        ((s[0] - t[0] - 1) - _limb2(h, 2), "u32div/rbound"),
    ]),
    "U32SPLIT": dict(right=range(1, 15), spec=lambda s, t, h, v: [
        (s[0] - _limb4(h), "u32split/decomp"),
        (t[0] - _limb2(h, 0), "u32split/lo"),
        (t[1] - _limb2(h, 2), "u32split/hi"),
        (_validity(h, _limb2(h, 0), _limb2(h, 2)), "u32split/valid"),
    ]),
    "U32ASSERT2": dict(no=range(0, 16), spec=lambda s, t, h, v: [
        (t[0] - _limb2(h, 2), "u32assert2/s0"),
        (t[1] - _limb2(h, 0), "u32assert2/s1"),
    ]),
    "U32ADD3": dict(left=range(3, 16),
                    spec=_u32_add_like(lambda s: s[0] + s[1] + s[2], "u32add3")),
    "U32MADD": dict(left=range(3, 16),
                    spec=_u32_mul_like(lambda s: s[0] * s[1] + s[2], "u32madd")),
    # -- control flow (stack side) ------------------------------------------
    "SPAN": dict(no=range(0, 16)),
    "JOIN": dict(no=range(0, 16)),
    "LOOP": dict(no=range(0, 16)),
    "RESPAN": dict(no=range(0, 16)),
    "HALT": dict(no=range(0, 16)),
    "CALL": dict(no=range(0, 16)),
    "SYSCALL": dict(no=range(0, 16)),
    "SPLIT": dict(left=range(1, 16)),
    "REPEAT": dict(left=range(1, 16)),
    "DYN": dict(left=range(1, 16)),
    "DYNCALL": dict(left=range(1, 16)),
    "PUSH": dict(right=range(0, 15)),  # t0 = immediate, bound by op-group table
    # END handled separately (conditional on h5)
}


class CoreVmAir(Air):
    """The Miden core AIR (system + decoder + stack + range, 51 columns,
    5 LogUp aux columns: accumulator + 4 fraction columns)."""

    width = L.CORE_WIDTH
    aux_width = 6
    num_randomness = 2
    num_aux_values = 1
    num_public_values = 40  # stack_in(16) | stack_out(16) | program_hash(4) | deferred_root(4)

    def eval(self, f) -> None:  # noqa: C901
        fl = OpFlags(f)
        flg = fl.flags
        b = fl.bits

        # Constraints are collected per selector kind and folded as four
        # stacked families — one α-fold each — so the compiled constraint
        # program size stays O(families), not O(constraints)
        # (the graph-size analog of folder.rs batched combinations).
        fam = {"zero": [], "trans": [], "first": [], "last": []}

        def A(kind, e, label):
            fam[kind].append((e, label))

        # ---- op bit / extra column well-formedness ------------------------
        for i in range(7):
            A("zero", b[i] * b[i] - b[i], f"opbit{i}/binary")
        A("zero", fl.e0 - b[6] * (1 - b[5]) * b[4], "extra0")
        A("zero", fl.e1 - b[6] * b[5], "extra1")
        A("zero", fl.u32_rc * b[0], "prefix100/b0")
        A("zero", fl.e1 * b[0], "prefix11/b0")
        A("zero", fl.e1 * b[1], "prefix11/b1")

        for name in FORBIDDEN_OPS:
            A("zero", flg[name], f"forbidden/{name.lower()}")
        # unused opcode slots in the degree-7/5 groups
        for code in (6, 47):
            lo = code & 0xF
            v5, v4 = (code >> 5) & 1, (code >> 4) & 1
            flag = (
                (1 - b[6])
                * (b[5] if v5 else 1 - b[5])
                * (b[4] if v4 else 1 - b[4])
            )
            for k in range(4):
                flag = flag * (b[k] if (lo >> k) & 1 else 1 - b[k])
            A("zero", flag, f"forbidden/op{code}")
        e0f = fl.e0
        for k in range(4):
            e0f = e0f * (b[k] if (15 >> k) & 1 else 1 - b[k])
        A("zero", e0f, "forbidden/op95")

        # ---- decoder: general ---------------------------------------------
        s = [f.main(c) for c in L.STACK_TOP]
        t = [f.main(c, 1) for c in L.STACK_TOP]
        h = [f.main(c) for c in L.HASHER]
        hn = [f.main(c, 1) for c in L.HASHER]
        a = f.main(L.ADDR)
        an = f.main(L.ADDR, 1)
        sp = f.main(L.IN_SPAN)
        spn = f.main(L.IN_SPAN, 1)
        gc = f.main(L.GROUP_COUNT)
        gcn = f.main(L.GROUP_COUNT, 1)
        ox = f.main(L.OP_INDEX)
        oxn = f.main(L.OP_INDEX, 1)
        clk = f.main(L.CLK)

        A("zero", flg["SPLIT"] * (s[0] * s[0] - s[0]), "split/binary")
        for i in range(4, 8):
            A("zero", flg["DYN"] * h[i], f"dyn/h{i}")
        A("zero", flg["REPEAT"] * (1 - s[0]), "repeat/s0")
        A("zero", flg["REPEAT"] * (1 - h[4]), "repeat/in_loop")
        A("trans", flg["RESPAN"] * (an - a - 2), "respan/addr")
        A("zero", flg["END"] * h[5] * s[0], "end/loop_cond")
        for i in range(5):
            A("trans", 
                flg["END"] * fl.next_ctrl["REPEAT"] * (hn[i] - h[i]),
                f"end_repeat/h{i}",
            )
        halt_next = fl.next_ctrl["HALT"]
        A("trans", flg["HALT"] * (1 - halt_next), "halt/chain")
        A("zero", flg["HALT"] * a, "halt/addr")
        for i in range(4):
            A("trans", flg["HALT"] * (hn[i] - h[i]), f"halt/h{i}")
        A("zero", 1 - sp - fl.control_flow, "in_span/ctrl")
        A("first", sp, "first/in_span")
        span_or_respan = flg["SPAN"] + flg["RESPAN"]
        A("trans", span_or_respan * (1 - spn), "span/next_sp")
        A("trans", sp * (an - a), "span/addr_copy")

        # ---- decoder: group count -----------------------------------------
        dgc = gc - gcn
        imm = fl.imm
        A("trans", sp * dgc * (dgc - 1), "gc/delta")
        A("trans", sp * dgc * (1 - imm) * h[0], "gc/group_done")
        A("trans", (span_or_respan + imm) * (dgc - 1), "gc/decrement")
        end_or_respan_next = fl.next_ctrl["END"] + fl.next_ctrl["RESPAN"]
        A("trans", dgc * end_or_respan_next, "gc/freeze")
        A("zero", flg["END"] * gc, "end/gc")

        # ---- decoder: op group decoding -----------------------------------
        op_next = sum(
            (f.main(L.OP_BITS[i], 1) * (1 << i) for i in range(1, 7)),
            f.main(L.OP_BITS[0], 1),
        )
        f_sgc = sp * spn * (1 - dgc)
        A("trans", 
            (span_or_respan + imm + f_sgc) * (h[0] - hn[0] * 128 - op_next),
            "opgroup/decode",
        )
        A("trans", sp * end_or_respan_next * h[0], "opgroup/exhausted")

        # ---- decoder: op index --------------------------------------------
        ng = dgc - imm
        A("trans", span_or_respan * oxn, "opindex/reset_span")
        A("trans", sp * ng * oxn, "opindex/reset_group")
        dox = oxn - ox
        A("trans", sp * spn * (1 - ng) * (dox - 1), "opindex/incr")
        prod = ox
        for i in range(1, 9):
            prod = prod * (ox - i)
        A("zero", prod, "opindex/range")

        # ---- decoder: batch flags -----------------------------------------
        c0 = f.main(L.BATCH_FLAGS[0])
        c1 = f.main(L.BATCH_FLAGS[1])
        c2 = f.main(L.BATCH_FLAGS[2])
        for i, c in enumerate((c0, c1, c2)):
            A("zero", c * c - c, f"batch{i}/binary")
        fg8 = c0
        fg4 = (1 - c0) * c1 * (1 - c2)
        fg2 = (1 - c0) * (1 - c1) * c2
        fg1 = (1 - c0) * c1 * c2
        A("zero", span_or_respan - (fg1 + fg2 + fg4 + fg8), "batch/one_hot")
        A("zero", (1 - span_or_respan) * (c0 + c1 + c2), "batch/off")
        for i in range(4, 8):
            A("zero", (fg1 + fg2 + fg4) * h[i], f"batch/le4_h{i}")
        for i in (2, 3):
            A("zero", (fg1 + fg2) * h[i], f"batch/le2_h{i}")
        A("zero", fg1 * h[1], "batch/le1_h1")

        # ---- system --------------------------------------------------------
        ctx = f.main(L.CTX)
        ctxn = f.main(L.CTX, 1)
        fn = [f.main(c) for c in L.FN_HASH]
        fnn = [f.main(c, 1) for c in L.FN_HASH]
        A("first", clk, "first/clk")
        A("first", ctx, "first/ctx")
        for i in range(4):
            A("first", fn[i], f"first/fn{i}")
        A("trans", f.main(L.CLK, 1) - clk - 1, "clk/incr")
        call_or_dyncall = flg["CALL"] + flg["DYNCALL"]
        A("trans", call_or_dyncall * (ctxn - clk - 1), "ctx/call")
        A("trans", flg["SYSCALL"] * ctxn, "ctx/syscall")
        end_call = flg["END"] * (h[6] + h[7])
        A("trans", 
            (1 - fl.call_entry - end_call) * (ctxn - ctx), "ctx/copy"
        )
        for i in range(4):
            A("trans", call_or_dyncall * (fnn[i] - h[i]), f"fn{i}/call")
            A("trans", 
                (1 - call_or_dyncall - flg["END"] * h[6]) * (fnn[i] - fn[i]),
                f"fn{i}/copy",
            )

        # ---- stack: per-op constraints ------------------------------------
        uh = [f.main(c) for c in L.USER_OP_HELPERS]
        b0 = f.main(L.B0)
        b0n = f.main(L.B0, 1)
        b1 = f.main(L.B1)
        b1n = f.main(L.B1, 1)
        sh0 = f.main(L.H0)
        env = {"fn": fn, "b0": b0, "clk": clk, "f": f}

        no_at = [None] * 16
        left_at = [None] * 16  # index d: s'_{d-1} = s_d
        right_at = [None] * 16  # index d: s'_{d+1} = s_d

        def acc(arr, d, flag):
            arr[d] = flag if arr[d] is None else arr[d] + flag

        for name, spec in STACK_SPEC.items():
            flag = flg[name]
            for d in spec.get("no", ()):
                acc(no_at, d, flag)
            for d in spec.get("left", ()):
                acc(left_at, d, flag)
            for d in spec.get("right", ()):
                if d < 15:
                    acc(right_at, d, flag)
            fn_spec = spec.get("spec")
            if fn_spec is not None:
                for expr, label in fn_spec(s, t, uh, env):
                    A("trans", flag * expr, f"{name.lower()}:{label}")
        # END: no-shift unless ending a loop (left shift)
        end_no = flg["END"] * (1 - h[5])
        end_left = flg["END"] * h[5]
        for d in range(16):
            acc(no_at, d, end_no)
            if d >= 1:
                acc(left_at, d, end_left)

        for d in range(16):
            if no_at[d] is not None:
                A("trans", no_at[d] * (t[d] - s[d]), f"stack/no_shift{d}")
            if d >= 1 and left_at[d] is not None:
                A("trans", 
                    left_at[d] * (t[d - 1] - s[d]), f"stack/left{d}"
                )
            if d < 15 and right_at[d] is not None:
                A("trans", 
                    right_at[d] * (t[d + 1] - s[d]), f"stack/right{d}"
                )

        # ---- stack: depth / overflow bookkeeping --------------------------
        f_ov = (b0 - 16) * sh0
        A("zero", (1 - f_ov) * (b0 - 16), "overflow/flag")
        f_shl = fl.shift_left
        f_shr = fl.shift_right
        A("trans", 
            (b0n - b0) * (1 - fl.call_entry - end_call)
            + f_shl * f_ov
            - f_shr
            + fl.call_entry * (b0n - 16),
            "stack/depth",
        )
        A("trans", f_shr * (b1n - clk), "overflow/push_addr")
        A("trans", f_shl * (1 - f_ov) * t[15], "stack/shift_in_zero")
        A("trans", 
            flg["DYNCALL"] * (1 - f_ov) * t[15], "stack/dyncall_shift_in_zero"
        )
        A("trans", fl.call_entry * b1n, "overflow/call_reset")

        # ---- range checker -------------------------------------------------
        rv = f.main(L.RC_VALUE)
        rvn = f.main(L.RC_VALUE, 1)
        dv = rvn - rv
        steps = dv
        for k in range(8):
            steps = steps * (dv - 3**k)
        A("trans", steps, "range/steps")
        A("first", rv, "range/first")
        A("last", rv - 65535, "range/last")

        # ---- boundaries ----------------------------------------------------
        for i in range(16):
            A("first", s[i] - f.public(i), f"boundary/stack_in{i}")
            A("last", s[i] - f.public(16 + i), f"boundary/stack_out{i}")
        A("first", b0 - 16, "boundary/b0_first")
        A("last", b0 - 16, "boundary/b0_last")
        A("first", b1, "boundary/b1_first")
        A("last", b1, "boundary/b1_last")
        for i in range(4):
            A("last", 
                h[i] - f.public(32 + i), f"boundary/program_hash{i}"
            )

        # ---- LogUp buses ---------------------------------------------------
        from .buses import core_bus_columns, seed_denominator

        cols, _ = core_bus_columns(f, fl)
        acc = f.aux(0)
        accn = f.aux(0, 1)
        total = acc
        for i, (V, U) in enumerate(cols):
            av = f.aux(1 + i)
            A("trans", U * av - V, f"bus/col{i}")
            total = total + av
        A("trans", accn - total, "bus/acc")
        # seed = block-hash-table init row (0, program_hash, 0, 0): the
        # accumulator starts at 1/d_seed and a balanced run ends at 0
        A("first", acc * seed_denominator(f) - 1, "bus/seed")
        A("last", acc - f.aux_value(0), "bus/final")

        # ---- flush: one stacked fold per selector kind ---------------------
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
