"""RPO-256 / RPX-256 (Rescue family) — exact host (int) implementation.

Reference: crates/crypto/src/hash/algebraic_sponge/rescue/{mod,rpo/mod,
rpx/mod}.rs. Parameters: Goldilocks, width 12, rate 8 (state 0..8),
capacity 4 (state 8..12), digest = state[0..4], 7 rounds, S-box x^7.

- RPO round: MDS → +ARK1 → x^7 → MDS → +ARK2 → x^{1/7}.
- RPX (XHash12) permutation: (FB)(E)(FB)(E)(FB)(E)(M) where FB is the RPO
  round, E is +ARK1 then x^7 in the cubic extension F_p[φ]/(φ³−φ−1) on
  four 3-element chunks, and M is MDS → +ARK1.

The sponge wrappers (hash_elements / merge / merge_in_domain / merge_many)
follow algebraic_sponge/mod.rs exactly — the same choreography as the
Poseidon2 crypto hasher (hash/poseidon2_host.py), only the permutation
differs. Known-answer vectors: rpo/tests.rs EXPECTED (19 vectors).
"""

from __future__ import annotations

from . import rescue_constants as RC

P = (1 << 64) - (1 << 32) + 1
RATE = 8
DIGEST = 4
INV_ALPHA = 10540996611094048183  # 7^-1 mod (p-1)

_MDS = [
    [RC.MDS_ROW0[(c - r) % 12] for c in range(12)] for r in range(12)
]


def _apply_mds(state: list[int]) -> list[int]:
    return [
        sum(_MDS[r][c] * state[c] for c in range(12)) % P for r in range(12)
    ]


def _sbox(state: list[int]) -> list[int]:
    return [pow(s, 7, P) for s in state]


def _inv_sbox(state: list[int]) -> list[int]:
    return [pow(s, INV_ALPHA, P) for s in state]


def _add(state: list[int], ark) -> list[int]:
    return [(s + k) % P for s, k in zip(state, ark)]


def _fb_round(state: list[int], r: int) -> list[int]:
    state = _sbox(_add(_apply_mds(state), RC.ARK1[r]))
    return _inv_sbox(_add(_apply_mds(state), RC.ARK2[r]))


def rpo_permute(state: list[int]) -> list[int]:
    assert len(state) == 12
    s = [v % P for v in state]
    for r in range(RC.NUM_ROUNDS):
        s = _fb_round(s, r)
    return s


# --- cubic extension F_p[φ]/(φ³ − φ − 1) (rpx/mod.rs cubic_ext) ---


def _c3_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    # (a0 + a1φ + a2φ²)(b0 + b1φ + b2φ²) mod (φ³ − φ − 1):
    # φ³ = φ + 1, φ⁴ = φ² + φ
    c0 = a0 * b0
    c1 = a0 * b1 + a1 * b0
    c2 = a0 * b2 + a1 * b1 + a2 * b0
    c3 = a1 * b2 + a2 * b1
    c4 = a2 * b2
    return (
        (c0 + c3) % P,
        (c1 + c3 + c4) % P,
        (c2 + c4) % P,
    )


def _c3_pow7(a):
    a2 = _c3_mul(a, a)
    a3 = _c3_mul(a2, a)
    a6 = _c3_mul(a3, a3)
    return _c3_mul(a6, a)


def _ext_round(state: list[int], r: int) -> list[int]:
    s = _add(state, RC.ARK1[r])
    out = []
    for b in (0, 3, 6, 9):
        out.extend(_c3_pow7((s[b], s[b + 1], s[b + 2])))
    return out


def rpx_permute(state: list[int]) -> list[int]:
    assert len(state) == 12
    s = [v % P for v in state]
    s = _fb_round(s, 0)
    s = _ext_round(s, 1)
    s = _fb_round(s, 2)
    s = _ext_round(s, 3)
    s = _fb_round(s, 4)
    s = _ext_round(s, 5)
    s = _add(_apply_mds(s), RC.ARK1[6])  # (M) final round
    return s


# --- sponge wrappers (algebraic_sponge/mod.rs semantics) ---


def _hash_elements_padded(permute, elements: list[int], domain: int = 0) -> list[int]:
    n = len(elements)
    state = [0] * 12
    state[8] = n % RATE
    state[9] = domain % P
    i = 0
    for e in elements:
        state[i] = e % P
        i += 1
        if i == RATE:
            state = permute(state)
            i = 0
    if i > 0:
        for j in range(i, RATE):
            state[j] = 0
        state = permute(state)
    elif n == 0 and state[9] != 0:
        state[0] = 1
        state = permute(state)
    return state[:4]


def _merge(permute, left, right) -> list[int]:
    state = list(left) + list(right) + [0, 0, 0, 0]
    return permute(state)[:4]


def _merge_in_domain(permute, left, right, domain: int) -> list[int]:
    state = list(left) + list(right) + [0, domain % P, 0, 0]
    return permute(state)[:4]


def _hash_elements_overwrite(permute, elements: list[int]) -> list[int]:
    """StatefulSponge overwrite-mode hash (zero state, overwrite rate,
    zero-pad the trailing partial chunk) — the LMCS leaf-hash semantics
    (crates/stateful-hasher/src/field_sponge.rs)."""
    state = [0] * 12
    for off in range(0, len(elements), 8):
        chunk = elements[off : off + 8]
        for i in range(8):
            state[i] = chunk[i] % P if i < len(chunk) else 0
        state = permute(state)
    return state[:4]


def rpo_hash_elements_stateful(elements):
    return _hash_elements_overwrite(rpo_permute, list(elements))


def rpx_hash_elements_stateful(elements):
    return _hash_elements_overwrite(rpx_permute, list(elements))


def rpo_compress(left, right):
    return rpo_permute(list(left) + list(right) + [0, 0, 0, 0])[:4]


def rpx_compress(left, right):
    return rpx_permute(list(left) + list(right) + [0, 0, 0, 0])[:4]
