"""Goldilocks NTT / LDE (kernels K1 and K2 on the card)."""

from . import ntt  # noqa: F401
