"""Lifted matrix commitment scheme (Poseidon2 configuration)."""

from . import lmcs  # noqa: F401
