"""R1 (`csrc/rescue.cu`, RPO-256) `rpo_absorb_rows`: see `harness/work.py` `absorb_rows`."""

from __future__ import annotations

from benchmarks.harness import work


def work_of(key: tuple) -> tuple:
    """(bytes, 32-bit multiplies) of one launch at the shape ``key``."""
    return work.absorb_rows("rpo", key)
