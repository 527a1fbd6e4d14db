"""R1 (`csrc/rescue.cu`, RPO-256) `rpo_permute`: see `harness/work.py` `permute`."""

from __future__ import annotations

from benchmarks.harness import work


def work_of(key: tuple) -> tuple:
    """(bytes, 32-bit multiplies) of one launch at the shape ``key``."""
    return work.permute("rpo", key)
