"""Hashing: batched torch Poseidon2 (kernel K3 on the card), RPO-256 and
RPX-256 (kernels R1 and R2), and the exact host twins (Poseidon2, RPO/RPX,
and the BLAKE3 / Keccak-256 the VM host layer uses)."""

from . import (  # noqa: F401
    blake3_host,
    constants,
    keccak_host,
    poseidon2,
    poseidon2_host,
    rescue,
    rescue_constants,
    rescue_host,
)
