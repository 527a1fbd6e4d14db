"""Miden VM arithmetization: op flags and the core AIR constraint families.

Behavioral spec: air/src/constraints/ in the reference — op flag
degree-reduction scheme (op_flags/mod.rs), decoder constraints
(docs/src/design/decoder/constraints.md), stack constraints
(docs/src/design/stack/), range checker (docs/src/design/range.md).
"""

from .core import CoreVmAir, check_core_trace

__all__ = ["CoreVmAir", "check_core_trace"]
