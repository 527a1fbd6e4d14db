"""Multi-device proving on ``torch.distributed`` (``miden_tpu/dist/``).

The port's counterpart of the reference's rayon row-parallelism
(SURVEY.md §2.8): the trace-row axis is sharded over the ranks of a process
group, one device each —

- :mod:`.mesh` — the :class:`~.mesh.Mesh` over a group (NCCL on cards,
  gloo through host memory), row blocks (:class:`~.mesh.RowShard`) and the
  collectives: exchange, gather, halo, all-to-all, partial sums and the
  gather at the query indices;
- :mod:`.ntt_dist` — the coset LDE, as a sharded interpolation and a
  sharded evaluation, whose first / last ``log2 D`` butterfly stages
  exchange whole blocks between partner ranks;
- :mod:`.lmcs_dist` — LMCS commitment with per-rank subtrees that stay
  sharded, and a gather of the block roots for the top layers;
- :mod:`.context` — ``use_mesh``, the hook under which every stage of the
  prover keeps the max-height rows sharded;
- :mod:`.prover` — ``prove_sharded``, and the walk of what a proof keeps
  sharded (``held_bytes``).

Everything is byte-identical to the single-device pipeline
(tests/test_torch_dist.py, exact equality on gloo ranks).
"""

from .context import active_mesh, use_mesh
from .mesh import make_mesh, replicate, shard_rows

__all__ = ["make_mesh", "shard_rows", "replicate", "use_mesh", "active_mesh"]
