"""miden_tpu_torch.merkle.lmcs ≡ miden_tpu.merkle.lmcs (exact), on the CPU.

Trees over mixed-height matrices (cyclic lifting, ragged widths) must have
the JAX package's digest layers; the opening hints that the port's query
gather emits must equal those of the JAX gather, and both packages'
``verify_batch`` must accept the port's openings.
"""

import numpy as np
import pytest
import torch

from miden_tpu.field.goldilocks import fp_from_u64, fp_to_u64
from miden_tpu.merkle import lmcs as JL
from miden_tpu.transcript import challenger as JC
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.hash import poseidon2 as P2
from miden_tpu_torch.merkle import lmcs as L
from miden_tpu_torch.transcript import challenger as C

SHAPES = [
    [(16, 5), (4, 3)],
    [(32, 51), (8, 22), (2, 16)],
    [(8, 0), (8, 9)],
    [(1, 8)],
]


def _mats(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, gl.P, size=s, dtype=np.uint64) for s in shapes]


@pytest.mark.parametrize("shapes", SHAPES, ids=[str(s) for s in SHAPES])
def test_tree_layers_match_jax(shapes):
    mats = _mats(len(shapes), shapes)
    tree = L.build_tree([F.to_torch(m, "cpu") for m in mats])
    jtree = JL.build_tree([fp_from_u64(m) for m in mats])
    assert len(tree.layers) == len(jtree.layers)
    for mine, theirs in zip(tree.layers, jtree.layers):
        assert (F.to_numpy(mine) == fp_to_u64(theirs)).all()
    assert (tree.root() == jtree.root()).all()


@pytest.mark.parametrize("width", [1, 7, 8, 9, 22, 51])
@pytest.mark.parametrize("h,max_h", [(16, 16), (4, 16), (1, 8)])
def test_absorb_rows_matches_jax_sponge(width, h, max_h):
    """One matrix through the port's row sponge (lifted when h < max_h, the
    ragged tail block zero-padded) against miden_tpu's incremental sponge."""
    (mat,) = _mats(width * 100 + h, [(h, width)])
    state = torch.zeros((12, max_h), dtype=torch.int64)
    got = F.to_numpy(P2.absorb_rows(state, F.to_torch(mat, "cpu"))[:4].T)
    want = fp_to_u64(JL._sponge_leaves_incremental([fp_from_u64(mat)], [h], max_h))
    assert (got == want).all()


def test_absorb_rows_continues_a_sponge():
    """Absorbing matrices one after another is the sponge over their lifted
    concatenation, as miden_tpu's leaves are."""
    shapes = [(32, 51), (8, 22), (2, 16), (32, 3)]
    mats = _mats(11, shapes)
    state = torch.zeros((12, 32), dtype=torch.int64)
    for m in mats:
        state = P2.absorb_rows(state, F.to_torch(m, "cpu"))
    want = JL._sponge_leaves_incremental([fp_from_u64(m) for m in mats], [h for h, _ in shapes], 32)
    assert (F.to_numpy(state[:4].T) == fp_to_u64(want)).all()


def test_sibling_schedule_matches_jax():
    for idx, depth in [([0], 3), ([1, 2, 5, 6], 3), ([0, 3, 9, 12, 15], 4), ([], 2)]:
        assert L.sibling_schedule(idx, depth) == JL.sibling_schedule(idx, depth)


def _port_hints(tree, raw):
    ch = C.ProverChannel(C.DuplexChallenger([0, 0, 0, 0]))
    flat, meta = L.gather_query_data(tree, torch.tensor(raw, dtype=torch.int64))
    L.emit_opening_hints(ch, F.to_numpy(flat), meta, raw)
    return ch


def _jax_hints(jtree, raw):
    import jax.numpy as jnp

    ch = JC.ProverChannel(JC.DuplexChallenger([0, 0, 0, 0]))
    flat, meta = JL.gather_query_data(jtree, jnp.asarray(raw, dtype=jnp.int32))
    JL.emit_opening_hints(ch, fp_to_u64(flat), meta, raw)
    return ch


@pytest.mark.parametrize("raw", [[3], [0, 5, 5, 31, 12, 7], [31, 30, 1, 0]])
def test_opening_hints_match_jax_and_both_verifiers_accept(raw):
    shapes = SHAPES[1]
    mats = _mats(7, shapes)
    tree = L.build_tree([F.to_torch(m, "cpu") for m in mats])
    jtree = JL.build_tree([fp_from_u64(m) for m in mats])
    mine, theirs = _port_hints(tree, raw), _jax_hints(jtree, raw)
    assert mine.fields == theirs.fields
    assert mine.commitments == theirs.commitments

    widths = [w for _, w in shapes]
    _, data = mine.finalize()
    rows = JL.verify_batch(
        tree.root(), widths, 32, raw,
        JC.VerifierChannel(JC.TranscriptData(data.fields, data.commitments), JC.DuplexChallenger([0, 0, 0, 0])),
    )
    rows2 = L.verify_batch(tree.root(), widths, 32, raw, C.VerifierChannel(data, C.DuplexChallenger([0, 0, 0, 0])))
    for d in set(raw):
        for (h, _), m, r, r2 in zip(shapes, mats, rows[d], rows2[d]):
            assert (r == m[d % h]).all() and (r2 == m[d % h]).all()


def test_verify_rejects_a_tampered_row():
    mats = _mats(8, [(8, 3)])
    tree = L.build_tree([F.to_torch(mats[0], "cpu")])
    ch = _port_hints(tree, [2, 5])
    _, data = ch.finalize()
    data.fields[0] = (data.fields[0] + 1) % gl.P
    with pytest.raises(ValueError):
        L.verify_batch(tree.root(), [3], 8, [2, 5], C.VerifierChannel(data, C.DuplexChallenger([0, 0, 0, 0])))


@pytest.mark.parametrize("name", sorted(L.HASH_CONFIGS))
def test_every_hash_config_commits_and_opens(name):
    """Every configuration of HASH_CONFIGS builds a small tree on the CPU and
    opens it: its own verifier accepts the rows, and a tampered row fails."""
    cfg = L.HASH_CONFIGS[name]()
    assert cfg.name == name
    shapes = SHAPES[0]
    mats = _mats(9, shapes)
    tree = L.build_tree([F.to_torch(m, "cpu") for m in mats], hash=cfg)
    raw = [1, 6, 13, 6]
    ch = _port_hints(tree, raw)
    _, data = ch.finalize()
    rows = L.verify_batch(tree.root(), [5, 3], 16, raw, C.VerifierChannel(data, C.DuplexChallenger([0, 0, 0, 0])), hash=cfg)
    for d in set(raw):
        assert (rows[d][0] == mats[0][d]).all() and (rows[d][1] == mats[1][d % 4]).all()
    data.fields[0] = (data.fields[0] + 1) % gl.P
    with pytest.raises(ValueError):
        L.verify_batch(tree.root(), [5, 3], 16, raw, C.VerifierChannel(data, C.DuplexChallenger([0, 0, 0, 0])), hash=cfg)
