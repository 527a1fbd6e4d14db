"""miden_tpu_torch.merkle.lmcs.prove_batch ≡ miden_tpu.merkle.lmcs.prove_batch.

The standalone batch opening, under all five commitment hashes: for the
same tree and indices the port's transcript (hinted rows, then sibling
digests in ``sibling_schedule`` order) equals ``miden_tpu``'s field for
field, and both packages' ``verify_batch`` accept it. ``miden_tpu``'s own
trees are used for Poseidon2 only: its rpo256 / rpx256 trees absorb their
leaves with Poseidon2 (a reference fault the port repairs), its byte-hash
trees compile for minutes on XLA:CPU and its RPX permutation does not
compile here at all, so under the other hashes ``miden_tpu`` opens the
port's tree (its matrices and digest layers); its verifier recomputes every
digest with the host hashes (``rescue_host`` for RPX).
"""

import numpy as np
import pytest
import torch

from miden_tpu.field.goldilocks import fp_from_u64, fp_to_u64
from miden_tpu.merkle import lmcs as JL
from miden_tpu.transcript import challenger as JC
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.merkle import lmcs as L
from miden_tpu_torch.transcript import challenger as C

SEED = [0x6D75, 0x6C74, 0x6968, 0x6173]
SHAPES = [(16, 5), (4, 3), (16, 0), (8, 9)]
HASHES = ["poseidon2", "rpo256", "rpx256", "blake3_256", "keccak256"]


def _mats():
    rng = np.random.default_rng(23)
    return [rng.integers(0, gl.P, size=s, dtype=np.uint64) for s in SHAPES]


def _trees(name):
    mats = _mats()
    tree = L.build_tree([F.to_torch(m, "cpu") for m in mats], hash=L.HASH_CONFIGS[name]())
    if name == "poseidon2":
        jtree = JL.build_tree([fp_from_u64(m) for m in mats])
        for mine, theirs in zip(tree.layers, jtree.layers):
            assert (F.to_numpy(mine) == fp_to_u64(theirs)).all()
    else:
        jtree = JL.LmcsTree(
            matrices=[fp_from_u64(m) for m in mats], heights=list(tree.heights), widths=list(tree.widths),
            layers=[fp_from_u64(F.to_numpy(layer)) for layer in tree.layers],
        )
    return mats, tree, jtree


@pytest.mark.parametrize("indices", [[3], [1, 6, 13, 6], [15, 0, 8, 7, 2]], ids=["one", "repeat", "five"])
@pytest.mark.parametrize("name", HASHES)
def test_transcript_equals_miden_tpu_and_both_verifiers_accept(name, indices):
    mats, tree, jtree = _trees(name)
    mine = C.ProverChannel(C.DuplexChallenger(SEED))
    L.prove_batch(tree, indices, mine)
    theirs = JC.ProverChannel(JC.DuplexChallenger(SEED))
    JL.prove_batch(jtree, indices, theirs)
    assert mine.fields == [int(v) for v in theirs.fields]
    assert mine.commitments == [tuple(int(v) for v in c) for c in theirs.commitments]
    digest, data = mine.finalize()
    j_digest, j_data = theirs.finalize()
    assert list(digest) == [int(v) for v in j_digest]

    widths, root = [w for _, w in SHAPES], [int(v) for v in tree.root()]
    rows = L.verify_batch(root, widths, 16, indices, C.VerifierChannel(data, C.DuplexChallenger(SEED)),
                          hash=L.HASH_CONFIGS[name]())
    j_rows = JL.verify_batch(
        root, widths, 16, indices,
        JC.VerifierChannel(JC.TranscriptData(data.fields, data.commitments), JC.DuplexChallenger(SEED)),
        hash=JL.HASH_CONFIGS[name](),
    )
    for d in set(indices):
        for (h, _), m, r, jr in zip(SHAPES, mats, rows[d], j_rows[d]):
            assert (r == m[d % h]).all() and (np.asarray(jr) == m[d % h]).all()


@pytest.mark.parametrize("name", HASHES)
def test_both_verifiers_reject_a_tampered_root(name):
    _, tree, _ = _trees(name)
    ch = C.ProverChannel(C.DuplexChallenger(SEED))
    L.prove_batch(tree, [2, 9], ch)
    _, data = ch.finalize()
    bad = [int(v) for v in tree.root()]
    bad[0] ^= 1
    widths = [w for _, w in SHAPES]
    with pytest.raises(ValueError):
        L.verify_batch(bad, widths, 16, [2, 9], C.VerifierChannel(data, C.DuplexChallenger(SEED)),
                       hash=L.HASH_CONFIGS[name]())
    with pytest.raises(ValueError):
        JL.verify_batch(
            bad, widths, 16, [2, 9],
            JC.VerifierChannel(JC.TranscriptData(data.fields, data.commitments), JC.DuplexChallenger(SEED)),
            hash=JL.HASH_CONFIGS[name](),
        )


def test_prove_batch_streams_what_the_proof_path_emits():
    """prove_batch is the proof path's gather and hint emission over the
    sorted unique indices."""
    _, tree, _ = _trees("poseidon2")
    raw = [9, 4, 4, 15]
    a = C.ProverChannel(C.DuplexChallenger(SEED))
    L.prove_batch(tree, raw, a)
    b = C.ProverChannel(C.DuplexChallenger(SEED))
    uniq = sorted(set(raw))
    flat, meta = L.gather_query_data(tree, torch.tensor(uniq, dtype=torch.int64))
    L.emit_opening_hints(b, F.to_numpy(flat), meta, uniq)
    assert (a.fields, a.commitments) == (b.fields, b.commitments)
