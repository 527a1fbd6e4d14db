"""Pure-Python Poseidon2 permutation + sponge (exact ground truth).

Implements the same permutation as p3-goldilocks `default_goldilocks_poseidon2_12`
(reference: crates/crypto/src/hash/algebraic_sponge/poseidon2/mod.rs, constants
in constants.rs; pinned by the reference test vector in poseidon2/test.rs).

Used for:
- the Fiat-Shamir challenger (scalar, O(1) state — host-side by design);
- the verifier's Merkle path checks;
- ground-truth tests for the batched torch permutation in ``poseidon2.py``.

Structure: mds_external, then 4 external rounds (ARC, x^7, mds_external), 22
internal rounds (ARC+sbox on lane 0, internal matrix = all-ones + diag), then
4 terminal external rounds. External matrix applies the 4x4 block
M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] per chunk plus cross-chunk sums.
"""

from __future__ import annotations

from ..field import gl
from . import constants as C

P = gl.P

_M4 = ((2, 3, 1, 1), (1, 2, 3, 1), (1, 1, 2, 3), (3, 1, 1, 2))


def _sbox(x: int) -> int:
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * x2 % P * x % P


def _mds_external(s: list[int]) -> list[int]:
    out = [0] * 12
    for b in range(0, 12, 4):
        c = s[b : b + 4]
        for r in range(4):
            out[b + r] = (
                _M4[r][0] * c[0] + _M4[r][1] * c[1] + _M4[r][2] * c[2] + _M4[r][3] * c[3]
            ) % P
    sums = [(out[l] + out[4 + l] + out[8 + l]) % P for l in range(4)]
    return [(out[i] + sums[i & 3]) % P for i in range(12)]


def permute(state: list[int]) -> list[int]:
    """Poseidon2 permutation on a 12-element Goldilocks state."""
    s = _mds_external(list(state))
    for r in range(C.NUM_EXTERNAL_ROUNDS_HALF):
        rc = C.ARK_EXT_INITIAL[r * 12 : r * 12 + 12]
        s = _mds_external([_sbox((x + k) % P) for x, k in zip(s, rc)])
    for r in range(C.NUM_INTERNAL_ROUNDS):
        s0 = _sbox((s[0] + C.ARK_INT[r]) % P)
        total = (s0 + sum(s[1:])) % P
        s = [(total + C.MAT_DIAG[i] * (s0 if i == 0 else s[i])) % P for i in range(12)]
    for r in range(C.NUM_EXTERNAL_ROUNDS_HALF):
        rc = C.ARK_EXT_TERMINAL[r * 12 : r * 12 + 12]
        s = _mds_external([_sbox((x + k) % P) for x, k in zip(s, rc)])
    return s


def _internal_round(s: list[int], rc: int) -> tuple[list[int], int]:
    """One internal round; returns (new state, s-box output witness)."""
    s0 = _sbox((s[0] + rc) % P)
    total = (s0 + sum(s[1:])) % P
    return [
        (total + C.MAT_DIAG[i] * (s0 if i == 0 else s[i])) % P for i in range(12)
    ], s0


def permute_packed_rows(state: list[int]) -> tuple[list[list[int]], list[list[int]]]:
    """The 16-row packed Poseidon2 schedule (docs chiplets/hasher.md
    §poseidon2-permutation-air): returns (states, witnesses) where
    states[r] is the pre-transition state stored on cycle row r
    (states[15] = permutation output) and witnesses[r] the three s-box
    witness cells for row r (zeros where unused).

    Schedule: row 0 = initial linear layer + external round 1; rows 1-3 =
    external rounds 2-4; rows 4-10 = internal rounds in packs of 3;
    row 11 = final internal round + terminal external round 1; rows
    12-14 = terminal external rounds 2-4; row 15 = output.
    """
    states: list[list[int]] = []
    wits: list[list[int]] = []
    s = [x % P for x in state]

    def ext_round(cur, rc):
        return _mds_external([_sbox((x + k) % P) for x, k in zip(cur, rc)])

    # row 0: initial linear layer + first external round
    states.append(list(s))
    wits.append([0, 0, 0])
    s = ext_round(_mds_external(s), C.ARK_EXT_INITIAL[0:12])
    # rows 1-3: external rounds 2-4
    for r in range(1, 4):
        states.append(list(s))
        wits.append([0, 0, 0])
        s = ext_round(s, C.ARK_EXT_INITIAL[12 * r : 12 * r + 12])
    # rows 4-10: internal rounds packed 3 per row
    for pack in range(7):
        states.append(list(s))
        w = []
        for j in range(3):
            s, sw = _internal_round(s, C.ARK_INT[3 * pack + j])
            w.append(sw)
        wits.append(w)
    # row 11: final internal round + terminal external round 1
    states.append(list(s))
    s, sw = _internal_round(s, C.ARK_INT[21])
    wits.append([sw, 0, 0])
    s = ext_round(s, C.ARK_EXT_TERMINAL[0:12])
    # rows 12-14: terminal external rounds 2-4
    for r in range(1, 4):
        states.append(list(s))
        wits.append([0, 0, 0])
        s = ext_round(s, C.ARK_EXT_TERMINAL[12 * r : 12 * r + 12])
    # row 15: output
    states.append(list(s))
    wits.append([0, 0, 0])
    return states, wits


def hash_elements(elements: list[int]) -> list[int]:
    """Overwrite-mode sponge hash (StatefulSponge semantics): zero state,
    absorb rate-8 chunks by overwriting state[0..8] (zero-padding partial
    chunks), permute per chunk; digest = state[0..4].

    Matches `StatefulSponge::<P, 12, 8, 4>::hash_rows` for a single row
    (crates/stateful-hasher/src/field_sponge.rs).
    """
    state = [0] * 12
    absorb(state, elements)
    return state[:4]


def absorb(state: list[int], elements: list[int]) -> None:
    """Absorb one row into a sponge state in-place (overwrite mode, zero-pad
    partial trailing chunk). Empty input is a no-op."""
    n = len(elements)
    for off in range(0, n, 8):
        chunk = elements[off : off + 8]
        for i in range(8):
            state[i] = chunk[i] if i < len(chunk) else 0
        state[:] = permute(state)


def compress(left: list[int], right: list[int]) -> list[int]:
    """2-to-1 Merkle compression: TruncatedPermutation<P, 2, 4, 12> —
    state = left || right || zeros, permute, take first 4."""
    state = list(left) + list(right) + [0, 0, 0, 0]
    return permute(state)[:4]


# ---------------------------------------------------------------------------
# Crypto-hasher sponge (`Poseidon2` in crates/crypto) — DISTINCT from the
# StatefulSponge overwrite-mode absorption above. This variant tags the
# capacity with `total_len % 8` and absorbs sequentially with zero padding
# (reference: crates/crypto/src/hash/algebraic_sponge/mod.rs,
# hash_elements_internal). Used by Merkle structures, MAST digests, program
# hashes — anywhere `Poseidon2::hash_elements / merge` appears.
# ---------------------------------------------------------------------------

RATE = 8
DIGEST = 4


def merge(left: list[int], right: list[int]) -> list[int]:
    """`Poseidon2::merge`: rate = left || right, capacity zero, one permute.

    Identical state layout to :func:`compress` (algebraic_sponge/mod.rs:153).
    """
    return compress(left, right)


def merge_in_domain(left: list[int], right: list[int], domain: int) -> list[int]:
    """`Poseidon2::merge_in_domain` (algebraic_sponge/mod.rs:177): like merge
    but capacity[1] (state index 9) carries the domain separator."""
    state = list(left) + list(right) + [0, domain % P, 0, 0]
    return permute(state)[:4]


def hash_elements_padded(elements: list[int], domain: int = 0) -> list[int]:
    """`Poseidon2::hash_elements{,_in_domain}` (algebraic_sponge/mod.rs:197):
    capacity[0] = len % 8, capacity[1] = domain; absorb rate-8 chunks
    sequentially, zero-pad the trailing partial chunk; empty input with a
    nonzero domain absorbs a ONE marker. Digest = state[0..4]."""
    n = len(elements)
    state = [0] * 12
    state[8] = n % RATE
    state[9] = domain % P
    i = 0
    for e in elements:
        state[i] = e % P
        i += 1
        if i == RATE:
            state[:] = permute(state)
            i = 0
    if i > 0:
        for j in range(i, RATE):
            state[j] = 0
        state[:] = permute(state)
    elif n == 0 and state[9] != 0:
        state[0] = 1
        state[:] = permute(state)
    return state[:4]


def merge_many(words: list[list[int]]) -> list[int]:
    """`Poseidon2::merge_many`: sequential-sponge hash of the flattened
    digests (algebraic_sponge/mod.rs:168)."""
    flat = [x for w in words for x in w]
    return hash_elements_padded(flat)
