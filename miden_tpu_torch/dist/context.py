"""Active-mesh context: routes the prover's commits to their sharded twins
(``miden_tpu/dist/context.py``).

``prove()`` itself takes no mesh. Entering :func:`use_mesh` makes the
commits run their row-sharded versions (:mod:`.ntt_dist`, :mod:`.lmcs_dist`);
the trees they return carry the mesh and hold their max-height rows as
:class:`~.mesh.RowShard` s, and every later stage (quotient, DEEP, FRI,
openings) keeps those rows sharded by reading them (:mod:`.prover`). This
mirrors how the reference scopes rayon parallelism to the hot loops
(SURVEY.md §2.8) rather than threading a pool through every function
signature.
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
