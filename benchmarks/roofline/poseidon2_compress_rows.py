"""K3 (`csrc/poseidon2.cu`) `poseidon2_compress_rows`: see `harness/work.py` `compress_rows`."""

from __future__ import annotations

from benchmarks.harness import work


def work_of(key: tuple) -> tuple:
    """(bytes, 32-bit multiplies) of one launch at the shape ``key``."""
    return work.compress_rows("poseidon2", key)
