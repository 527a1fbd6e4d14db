"""Poseidon2 hashing: batched torch permutation (kernel K3 on the card) and
the exact host twin."""

from . import constants, poseidon2, poseidon2_host  # noqa: F401
