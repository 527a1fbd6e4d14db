"""Active-mesh context: routes the prover's commit stages to their sharded
twins (``miden_tpu/dist/context.py``).

``prove()`` itself takes no mesh. Entering :func:`use_mesh` makes the two
stages where the row layout matters (trace and quotient commitment: NTT
butterflies and Merkle folds) run their row-sharded versions
(:mod:`.ntt_dist`, :mod:`.lmcs_dist`); every other stage runs the same on
every rank over the gathered tensors. This mirrors how the reference scopes
rayon parallelism to the hot loops (SURVEY.md §2.8) rather than threading a
pool through every function signature.
"""

from __future__ import annotations

from contextlib import contextmanager

_ACTIVE = None


def active_mesh():
    """The mesh set by the innermost :func:`use_mesh`, or None."""
    return _ACTIVE


@contextmanager
def use_mesh(mesh):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev
