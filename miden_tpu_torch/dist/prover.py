"""Multi-device STARK prove with row-sharded commits (``miden_tpu/dist/prover.py``).

:func:`prove_sharded` runs the whole of :func:`miden_tpu_torch.stark.prover.prove`
on every rank of a mesh: the trace and quotient commits run their
row-sharded twins (:mod:`.ntt_dist`, :mod:`.lmcs_dist`) through the
:mod:`.context` hook, and every other stage (aux, quotient, DEEP, FRI,
queries) runs the same on every rank over the gathered tensors. Every rank
ends with the same transcript, so the proof is byte-identical to the
single-device one: every hash absorbs rows in domain order whatever the
layout, and all arithmetic is exact.

``prove_program`` takes no mesh: a VM proof runs sharded as
``with use_mesh(mesh): prove_program(program, device=mesh.device)``.
"""

from __future__ import annotations

from ..stark.prover import StarkOutput, Statement, prove
from .context import use_mesh


def prove_sharded(params, statement: Statement, traces, challenger, mesh) -> StarkOutput:
    """Prove on every rank of ``mesh``, the commits row-sharded over it.
    ``traces``: numpy u64 or int64 tensors, instance order, the same on
    every rank."""
    with use_mesh(mesh):
        return prove(params, statement, list(traces), challenger, device=mesh.device)
