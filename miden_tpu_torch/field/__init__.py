"""Field layer: Goldilocks base field + quadratic extension.

- ``gl``         — pure-Python exact arithmetic (ground truth, host helpers).
- ``goldilocks`` — torch int64 tensor ops (the device representation).
"""

from . import gl, goldilocks  # noqa: F401
