"""Row-sharded LMCS commitment over a mesh (``miden_tpu/dist/lmcs_dist.py``).

The Merkle tree over ``max_h`` domain rows splits exactly at the block
boundary: with ``D`` ranks holding ``S = max_h/D`` rows each, every node at
level ``j ≤ log2 S`` covers rows of one block, so the leaves and the bottom
``log2 S`` digest layers are computed by each rank alone (K3
``absorb_rows`` / ``compress_rows`` on a card). The ``D`` block roots are
then gathered and the top ``log2 D`` layers fold the same way on every rank.
The result is layer for layer :func:`miden_tpu_torch.merkle.lmcs.build_tree`.

Lifting (shorter matrices): domain row ``d`` reads matrix row ``d mod h``.
Within block ``k`` that is the matrix itself, lifted by the sponge, when
``h ≤ S`` (``h`` divides ``k·S``), and the slice at ``(k·S) mod h`` when
``h > S``. Shorter matrices are held whole by every rank.

The returned :class:`~miden_tpu_torch.merkle.lmcs.LmcsTree` keeps what
``miden_tpu``'s keeps sharded as :class:`~.mesh.RowShard` s: every
max-height matrix (a whole one is cut to this rank's block) and the bottom
``log2 S + 1`` digest layers, down to the layer of the ``D`` block roots.
Only the top ``log2 D`` layers, folded from the gathered block roots, are
whole on every rank. The tree carries its mesh: its openings gather the
rows and siblings at the query indices from their owners
(:func:`~miden_tpu_torch.merkle.lmcs.gather_query_data`).

Reference analog: rayon-parallel leaf hashing and digest layers
(crates/lifted-stark/src/lmcs/lifted_tree.rs:81-100).
"""

from __future__ import annotations

import torch

from ..merkle import lmcs
from .mesh import Mesh, RowShard, gather_rows, shard_rows


def _local_lift_rows(m: torch.Tensor, h: int, shard: int, k: int) -> torch.Tensor:
    """What block ``k`` absorbs of a height-``h`` matrix: rows
    ``(k·S + j) mod h`` for ``j < S``, the cyclic part left to the sponge."""
    if h <= shard:
        return m
    start = (k * shard) % h
    return m[start : start + shard]


def build_tree_sharded(matrices, mesh: Mesh) -> lmcs.LmcsTree:
    """Sharded twin of :func:`miden_tpu_torch.merkle.lmcs.build_tree` under
    Poseidon2. ``matrices``: whole tensors, or this rank's
    :class:`RowShard` of a max-height matrix."""
    matrices = list(matrices)
    heights = [m.shape[0] for m in matrices]
    widths = [m.shape[1] for m in matrices]
    max_h = max(heights)
    if max_h % mesh.size:
        raise ValueError(f"build_tree_sharded: {max_h} rows over {mesh.size} ranks")
    shard = max_h // mesh.size
    hash_cfg = lmcs.POSEIDON2_HASH

    placed = []
    for m, h in zip(matrices, heights):
        if isinstance(m, RowShard):
            if h != max_h:
                raise ValueError("build_tree_sharded: only max-height matrices may be row-sharded")
        elif h == max_h:
            m = shard_rows(m, mesh)
        placed.append(m)
    state = torch.zeros((12, shard), dtype=torch.int64, device=mesh.device)
    for m, h in zip(placed, heights):
        local = m.local if isinstance(m, RowShard) else _local_lift_rows(m, h, shard, mesh.rank)
        state = hash_cfg.absorb_rows(state, local)
    cur = state[:4].T.contiguous()
    layers = [RowShard(cur, max_h)]
    while cur.shape[0] > 1:
        cur = hash_cfg.compress_rows(cur)
        layers.append(RowShard(cur, cur.shape[0] * mesh.size))
    cur = gather_rows(layers[-1], mesh)  # the D block roots
    while cur.shape[0] > 1:
        cur = hash_cfg.compress_rows(cur)
        layers.append(cur)
    return lmcs.LmcsTree(matrices=placed, heights=heights, widths=widths, layers=layers, mesh=mesh)
