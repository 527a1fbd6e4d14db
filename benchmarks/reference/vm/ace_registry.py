"""Committed ACE circuit registry + the relation digest FS binding.

Re-designs the reference's relation commitment (air/src/config.rs:84-180):
the accepted ACE circuits — one per VM AIR, generated by
:mod:`ace_codegen` from the live constraint system — are committed in a
Poseidon2 Merkle tree, and the Fiat–Shamir challenger seed becomes

    RELATION_SEED = Poseidon2([PROTOCOL_ID || registry_root])

so every proof is bound to the exact constraint system version: change
any constraint (or tamper with a circuit an in-VM verifier would
evaluate) and the registry root moves, the challenger seed moves, and
existing proofs stop verifying.

The registry leaves are indexed by VM AIR instance order (Core,
Chiplets, Poseidon2Permutation). The reference additionally permutes
circuits per proof-order tag (config.rs:110-113) because its circuits
bake the proof-order-dependent input layout; this framework's circuits
take per-AIR inputs only, so instance order is canonical and the proof
order binds separately through ``Statement.observe``'s log-height
stream.
"""

from __future__ import annotations

from functools import lru_cache

from .. import gl
from .. import poseidon2 as poseidon2_host

#: Protocol identity (the former PROTOCOL_SEED constant): version tag of
#: the wire protocol, now combined with the registry root below.
PROTOCOL_ID = [0x6D69_6465, 0x6E2D_7470, 0x752D_766D, 0x0000_0001]

#: Domain-separation prefix for circuit commitments.
_CIRCUIT_PREFIX = [0x4143_4500, 0x0000_0001]  # "ACE", v1


def circuit_commitment(circuit) -> tuple:
    """Poseidon2 commitment to one encoded ACE circuit: the full encoded
    form (shape header, interned constants, instruction words) — any
    single-gate change moves the digest. Instruction words are < 2^63 and
    therefore valid felts."""
    stream = list(_CIRCUIT_PREFIX)
    stream += [
        circuit.n_inputs,
        circuit.num_vars,
        circuit.num_eval,
        len(circuit.const_values),
    ]
    stream += [int(c) % gl.P for c in circuit.const_values]
    for w in circuit.instr_words:
        assert 0 <= w < gl.P
        stream.append(int(w))
    return tuple(poseidon2_host.hash_elements(stream))


def _merkle_root(leaves: list) -> tuple:
    """Poseidon2 2-to-1 tree over the leaf digests, zero-padded to the
    next power of two (zero words are canonical)."""
    level = [tuple(int(v) for v in leaf) for leaf in leaves]
    size = 1
    while size < len(level):
        size *= 2
    level += [(0, 0, 0, 0)] * (size - len(level))
    while len(level) > 1:
        level = [
            tuple(
                poseidon2_host.compress(list(level[i]), list(level[i + 1]))
            )
            for i in range(0, len(level), 2)
        ]
    return level[0]


@lru_cache(maxsize=1)
def vm_registry() -> tuple:
    """(root, leaf_digests, circuits) for the VM's three AIRs with the
    real statement input layout (40 publics — vm/prove.py vm_statement)."""
    from .ace_codegen import build_ace_circuit
    from .core_air import CoreVmAir
    from .chiplets_air import ChipletsVmAir
    from .poseidon2_air import Poseidon2PermutationAir

    airs = [CoreVmAir(), ChipletsVmAir(), Poseidon2PermutationAir()]
    circuits = tuple(
        build_ace_circuit(a, 40, a.num_randomness, a.num_aux_values)
        for a in airs
    )
    leaves = tuple(circuit_commitment(c) for c in circuits)
    return _merkle_root(list(leaves)), leaves, circuits


def registry_root() -> tuple:
    return vm_registry()[0]


@lru_cache(maxsize=1)
def relation_seed() -> tuple:
    """The challenger seed binding proofs to the committed relation."""
    return tuple(
        poseidon2_host.hash_elements(list(PROTOCOL_ID) + list(registry_root()))
    )
