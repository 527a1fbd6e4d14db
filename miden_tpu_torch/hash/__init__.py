"""Hashing: batched torch Poseidon2 (kernel K3 on the card) and the exact
host twins (Poseidon2, and the BLAKE3 / Keccak-256 the VM host layer uses)."""

from . import blake3_host, constants, keccak_host, poseidon2, poseidon2_host  # noqa: F401
