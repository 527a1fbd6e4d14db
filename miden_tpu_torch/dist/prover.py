"""Multi-device STARK prove over a row-sharded mesh (``miden_tpu/dist/prover.py``).

:func:`prove_sharded` runs the whole of :func:`miden_tpu_torch.stark.prover.prove`
on every rank of a mesh with the trace-row axis sharded, as ``miden_tpu``'s
does under GSPMD, but with every collective explicit:

- the commits run the row-sharded LDE (:mod:`.ntt_dist`) and tree
  (:mod:`.lmcs_dist`) through the :mod:`.context` hook; a tree keeps its
  max-height matrices and bottom layers as this rank's blocks
  (:class:`~.mesh.RowShard`), only its top ``log2 D`` layers whole;
- the constraints run on each rank's block of the quotient coset, the last
  ``D`` points reading their next rows from the next rank
  (:func:`~.mesh.halo_rows`; Q1's halo on the card); the Horner
  accumulation, the upsampling and the quotient chunks stay sharded (the
  two halves of the sharded NTT);
- the OOD claims add the ranks' partial sums in the field
  (:func:`~.mesh.sum_partials`), the DEEP quotient is each rank's block,
  each FRI round transposes the blocks between the ranks
  (:func:`~.mesh.all_to_all_rows`) until its matrix holds fewer than
  ``pcs.FRI_MIN_SHARD_ROWS`` rows a rank, and the openings gather the rows
  and siblings at the query indices from their owners
  (:func:`~.mesh.gather_at_many`).

What stays whole on every rank, as in ``miden_tpu``: the traces (each
rank builds the aux traces from the whole trace), every shorter matrix, the top tree layers,
the transcript, the trees of the other hashes (gathered,
:func:`~..stark.prover.shards_rows`), the FRI layers below the threshold and
the query rows. Every rank ends with the same transcript, so the proof is
byte-identical to the single-device one: every hash absorbs rows in domain
order whatever the layout, and all arithmetic is exact.

``prove_program`` takes no mesh: a VM proof runs sharded as
``with use_mesh(mesh): prove_program(program, device=mesh.device)``, fused
under an NCCL mesh on the card (:func:`~..stark.fused.use_fused`).
"""

from __future__ import annotations

from ..stark import pcs
from ..stark.prover import StarkOutput, Statement, prove
from .context import use_mesh
from .mesh import RowShard


def prove_sharded(params, statement: Statement, traces, challenger, mesh) -> StarkOutput:
    """Prove on every rank of ``mesh``, the rows sharded over it.
    ``traces``: numpy u64 or int64 tensors, instance order, the same on
    every rank."""
    with use_mesh(mesh):
        return prove(params, statement, list(traces), challenger, device=mesh.device)


def prove_sharded_env(params, statement: Statement, traces, challenger, mesh, after=None, device="cuda") -> tuple:
    """:func:`prove_sharded` run eagerly, with the stages' environment after
    the last phase (the committed trees, the FRI trees): ``(output, env)``.
    ``after``: :func:`~..stark.fused.run_phases`' hook. With ``mesh`` None
    it proves on ``device`` alone."""
    from ..stark import fused

    device = mesh.device if mesh is not None else device
    with use_mesh(mesh):
        run = fused.run_phases(*fused._prepare(params, statement, list(traces), challenger, None, device),
                               after=after)
        return run.finish(), run.env


def sharded_parts(env: dict, params, ranks: int) -> list:
    """``(name, tensor or RowShard, rows)`` of every tensor of ``env`` that
    ``ranks`` ranks keep row-sharded at the end of ``stage_open``: the
    max-height matrices and the layers of at least ``ranks`` rows of the
    main, aux and quotient trees and of each FRI tree whose round was
    sharded (its matrix ``FRI_MIN_SHARD_ROWS`` rows a rank or more). The
    same walk over one device's environment names the same tensors, whole."""
    trees = [("main", env["main_tree"]), ("aux", env["aux_tree"]), ("quotient", env["quotient_tree"])]
    trees += [
        (f"fri{r}", t) for r, t in enumerate(env["fri_trees"])
        if t.height // ranks >= pcs.FRI_MIN_SHARD_ROWS
    ]
    out = []
    for name, tree in trees:
        for i, (m, h) in enumerate(zip(tree.matrices, tree.heights)):
            if h == tree.height:
                out.append((f"{name} matrix {i}", m, h))
        for j, layer in enumerate(tree.layers):
            if layer.shape[0] >= ranks:
                out.append((f"{name} layer {j}", layer, layer.shape[0]))
    return out


def held_bytes(env: dict, params, ranks: int) -> dict:
    """What this rank holds of :func:`sharded_parts`: ``local`` bytes, the
    bytes one device holds of the same tensors whole (``whole``), and the
    names of any that are not a RowShard of ``rows/ranks`` rows
    (``not_sharded``: empty over a mesh of ``ranks``)."""
    local = whole = 0
    bad = []
    for name, x, rows in sharded_parts(env, params, ranks):
        t = x.local if isinstance(x, RowShard) else x
        row_bytes = t.element_size() * (t[0].numel() if t.shape[0] else 0)
        local += t.numel() * t.element_size()
        whole += rows * row_bytes
        if not isinstance(x, RowShard) or t.shape[0] * ranks != rows:
            bad.append(name)
    return {"local": local, "whole": whole, "not_sharded": bad}
