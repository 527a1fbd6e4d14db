"""Hashing: batched torch Poseidon2 (kernel K3 on the card), RPO-256 and
RPX-256 (kernels R1 and R2), batched BLAKE3 and Keccak-256 in plain torch
(the byte-hash LMCS configurations), SHA-256 and the incremental
``stateful`` hashers on the host, and the exact host twins (Poseidon2,
RPO/RPX, BLAKE3, Keccak-256)."""

from . import (  # noqa: F401
    blake3,
    blake3_host,
    constants,
    keccak,
    keccak_host,
    poseidon2,
    poseidon2_host,
    rescue,
    rescue_constants,
    rescue_host,
    sha2,
    stateful,
)
