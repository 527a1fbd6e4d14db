"""The port's RPO-256 / RPX-256 (``miden_tpu_torch.hash.rescue``) and its
rpo256 / rpx256 LMCS trees ≡ ``miden_tpu``'s, on the CPU.

Goldilocks arithmetic is exact, so every comparison is exact equality. The
plain torch twins are held to the exact int permutations of
``rescue_host`` (both packages' copies) and RPO also to
``miden_tpu.hash.rescue.rpo_permute`` on JAX-CPU. The sponge entries are
held to ``miden_tpu``'s sponge functions on its lifted, padded concatenation
of the same matrices, and the trees to ``miden_tpu``'s verifier.

JAX-CPU is used for RPO only: each RPO program takes XLA about ten seconds
to compile on an 8-core x86 CPU, while ``miden_tpu.hash.rescue.rpx_permute``
did not finish compiling there in 40 minutes, so RPX is held to
``rescue_host`` (the exact ints ``miden_tpu``'s own verifier hashes with).
"""

import numpy as np
import pytest
import torch

from miden_tpu.field.goldilocks import fp_from_u64, fp_to_u64
from miden_tpu.hash import poseidon2_host as j_poseidon2_host
from miden_tpu.hash import rescue as JR
from miden_tpu.hash import rescue_host as JH
from miden_tpu.merkle import lmcs as JL
from miden_tpu.transcript import challenger as JC
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.hash import rescue, rescue_host
from miden_tpu_torch.merkle import lmcs as L
from miden_tpu_torch.transcript import challenger as C

P = gl.P
SPONGES = {"rpo": rescue.RPO, "rpx": rescue.RPX}
HOST = {"rpo": rescue_host.rpo_permute, "rpx": rescue_host.rpx_permute}
J_HOST = {"rpo": JH.rpo_permute, "rpx": JH.rpx_permute}
HOST_LEAF = {"rpo": JH.rpo_hash_elements_stateful, "rpx": JH.rpx_hash_elements_stateful}
HOST_COMPRESS = {"rpo": JH.rpo_compress, "rpx": JH.rpx_compress}
TREE_HASH = {"rpo": (L.RPO_HASH, JL.rpo_hash), "rpx": (L.RPX_HASH, JL.rpx_hash)}

# First, middle and last of the reference's 19 RPO known-answer vectors
# (crates/crypto/src/hash/algebraic_sponge/rescue/rpo/tests.rs EXPECTED):
# hash_elements([0..n)).
RPO_VECTORS = {
    1: [8563248028282119176, 14757918088501470722, 14042820149444308297, 7607140247535155355],
    8: [5421234586123900205, 9738602082989433872, 7017816005734536787, 8635896173743411073],
    19: [17273934282489765074, 8007352780590012415, 16690624932024962846, 8137543572359747206],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU's cores; this module's torch
    work is small-tensor dispatch, as fast on one thread, and on eight it
    oversubscribes the cores the other workers use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _states(seed: int, n: int = 64) -> np.ndarray:
    """Random (12, n) states whose first columns hold 0, p − 1, ⌊p/2⌋ and
    ⌊p/2⌋ + 1 in every lane (values ≥ 2^63 are negative int64s)."""
    s = np.random.default_rng(seed).integers(0, P, size=(12, n), dtype=np.uint64)
    for j, v in enumerate((0, P - 1, P // 2, P // 2 + 1)):
        if j < n:
            s[:, j] = v
    return s


def _t(a: np.ndarray) -> torch.Tensor:
    return F.to_torch(a, "cpu")


def _cols(a: np.ndarray) -> list:
    return [[int(v) for v in a[:, j]] for j in range(a.shape[1])]


@pytest.mark.parametrize("which", ["rpo", "rpx"])
def test_plain_permutation_equals_rescue_host(which):
    s = _states(1 if which == "rpo" else 2)
    got = _cols(F.to_numpy(SPONGES[which].permute_plain(_t(s))))
    want = [HOST[which](col) for col in _cols(s)]
    assert got == want
    assert want == [J_HOST[which](col) for col in _cols(s)]  # the port's host copy ≡ miden_tpu's


def test_rpo_plain_permutation_equals_miden_tpu_jax():
    s = _states(3)
    want = np.asarray(fp_to_u64(JR.rpo_permute(fp_from_u64(s))))
    assert (F.to_numpy(rescue.rpo_permute_plain(_t(s))) == want).all()


def test_permute_takes_the_twin_on_the_cpu():
    s = _t(_states(4, 5))
    assert torch.equal(rescue.rpo_permute(s), rescue.rpo_permute_plain(s))
    assert torch.equal(rescue.rpx_permute(s), rescue.rpx_permute_plain(s))
    with pytest.raises(ValueError, match="CUDA"):
        rescue.RPO.permute_kernel(s)


def test_inverse_sbox_chain_is_the_seventh_root():
    x = _t(_states(5, 256)[0])
    y = rescue._inv_sbox(x)
    assert [int(v) for v in F.to_numpy(y)] == [pow(int(v), rescue.INV_ALPHA, P) for v in F.to_numpy(x)]
    assert torch.equal(rescue._sbox(y), x)


def test_rpo_known_answer_vectors():
    elements = list(range(19))
    for n, want in RPO_VECTORS.items():
        assert rescue_host.Rpo256.hash_elements(elements[:n]) == want


@pytest.mark.parametrize("which", ["rpo", "rpx"])
def test_host_hashers_equal_miden_tpu(which):
    mine = rescue_host.Rpo256 if which == "rpo" else rescue_host.Rpx256
    theirs = JH.Rpo256 if which == "rpo" else JH.Rpx256
    e = [int(v) for v in _states(6, 4)[:, 3]] + [7, 8, 9]
    assert mine.hash_elements(e) == theirs.hash_elements(e)
    assert mine.hash_elements(e, domain=5) == theirs.hash_elements(e, domain=5)
    assert mine.merge(e[:4], e[4:8]) == theirs.merge(e[:4], e[4:8])
    assert mine.merge_in_domain(e[:4], e[4:8], 9) == theirs.merge_in_domain(e[:4], e[4:8], 9)
    assert mine.merge_many([e[:4], e[4:8], e[8:12]]) == theirs.merge_many([e[:4], e[4:8], e[8:12]])


# ---------------------------------------------------------------------------
# Sponge entries: lifting, ragged tails, widths below the rate
# ---------------------------------------------------------------------------

SHAPES = [(16, 13), (4, 5), (1, 3), (16, 8), (8, 1)]  # (height, width); max height 16


def _mats(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, P, size=s, dtype=np.uint64) for s in SHAPES]


def _absorb_all(sponge, mats) -> np.ndarray:
    state = torch.zeros((12, 16), dtype=torch.int64)
    for m in mats:
        state = sponge.absorb_rows(state, _t(m))
    return F.to_numpy(state[:4].T.contiguous())


def _lifted_rows(mats) -> list:
    """Row d of the lifted, zero-padded concatenation, as ints."""
    rows = []
    for d in range(16):
        row = []
        for m in mats:
            r = [int(v) for v in m[d % m.shape[0]]]
            row += r + [0] * (L.aligned_width(len(r)) - len(r))
        rows.append(row)
    return rows


def test_rpo_absorb_rows_equals_miden_tpu_hash_blocks():
    mats = _mats(7)
    flat = JL._lift_pad_concat([fp_from_u64(m) for m in mats], [m.shape[0] for m in mats], 16)
    blocks = type(flat)(flat.lo.reshape(16, -1, 8), flat.hi.reshape(16, -1, 8))
    want = np.asarray(fp_to_u64(JR.rpo_hash_blocks(blocks)))
    assert (_absorb_all(rescue.RPO, mats) == want).all()


@pytest.mark.parametrize("which", ["rpo", "rpx"])
def test_absorb_rows_equals_the_host_sponge_on_each_lifted_row(which):
    mats = _mats(8)
    got = _absorb_all(SPONGES[which], mats)
    want = [HOST_LEAF[which](row) for row in _lifted_rows(mats)]
    assert [[int(v) for v in r] for r in got] == want


@pytest.mark.parametrize("which", ["rpo", "rpx"])
def test_compress_rows_equals_miden_tpu(which):
    cur = np.random.default_rng(9).integers(0, P, size=(128, 4), dtype=np.uint64)
    got = F.to_numpy(SPONGES[which].compress_rows(_t(cur)))
    rows = [[int(v) for v in r] for r in cur]
    want = [HOST_COMPRESS[which](rows[2 * i], rows[2 * i + 1]) for i in range(64)]
    assert [[int(v) for v in r] for r in got] == want
    if which == "rpo":  # RPO on JAX-CPU, at the (12, 64) shape of the permutation test
        j = JR.rpo_compress_pairs(fp_from_u64(cur[0::2]), fp_from_u64(cur[1::2]))
        assert (np.asarray(fp_to_u64(j)) == got).all()
    pairs = SPONGES[which].compress_pairs(_t(cur[0::2]), _t(cur[1::2]))
    assert (F.to_numpy(pairs) == got).all()


# ---------------------------------------------------------------------------
# Trees and openings against miden_tpu's verifier
# ---------------------------------------------------------------------------


def _open(tree, raw):
    ch = C.ProverChannel(C.DuplexChallenger([0, 0, 0, 0]))
    flat, meta = L.gather_query_data(tree, torch.tensor(raw, dtype=torch.int64))
    L.emit_opening_hints(ch, F.to_numpy(flat), meta, raw)
    _, data = ch.finalize()
    return data


@pytest.mark.parametrize("which", ["rpo", "rpx"])
def test_tree_openings_pass_miden_tpu_verify_batch(which):
    mine, theirs = TREE_HASH[which]
    mats = _mats(10)
    tree = L.build_tree([_t(m) for m in mats], hash=mine)
    assert L.HASH_CONFIGS[mine.name]() is mine
    raw = [3, 14, 3, 9]
    data = _open(tree, raw)
    widths = [m.shape[1] for m in mats]
    rows = JL.verify_batch(
        tree.root(), widths, 16, raw,
        JC.VerifierChannel(JC.TranscriptData(data.fields, data.commitments), JC.DuplexChallenger([0, 0, 0, 0])),
        hash=theirs(),
    )
    for d in set(raw):
        for m, r in zip(mats, rows[d]):
            assert (r == m[d % m.shape[0]]).all()
    L.verify_batch(tree.root(), widths, 16, raw, C.VerifierChannel(data, C.DuplexChallenger([0, 0, 0, 0])), hash=mine)

    data.fields[1] = (data.fields[1] + 1) % P  # a tampered row
    with pytest.raises(ValueError, match="root mismatch"):
        JL.verify_batch(
            tree.root(), widths, 16, raw,
            JC.VerifierChannel(JC.TranscriptData(data.fields, data.commitments), JC.DuplexChallenger([0, 0, 0, 0])),
            hash=theirs(),
        )
    with pytest.raises(ValueError, match="root mismatch"):
        L.verify_batch(tree.root(), widths, 16, raw, C.VerifierChannel(data, C.DuplexChallenger([0, 0, 0, 0])), hash=mine)


def test_miden_tpu_rpo_tree_leaves_are_poseidon2_and_the_port_repairs_it():
    """Pins a fault of miden_tpu: ``_sponge_leaves_incremental``
    (miden_tpu/merkle/lmcs.py:373) absorbs every algebraic configuration's
    leaves with ``poseidon2.permute``, while its verifier rehashes them with
    the configuration's host sponge (lmcs.py:698), so its rpo256 / rpx256
    proofs cannot verify. The port absorbs with RPO. If this test fails
    because miden_tpu's leaves became RPO digests, the fault was repaired
    there: update ROADMAP.md §3 and this test."""
    m = np.random.default_rng(11).integers(0, P, size=(4, 8), dtype=np.uint64)
    rows = [[int(v) for v in r] for r in m]
    theirs = fp_to_u64(JL.build_tree([fp_from_u64(m)], hash=JL.rpo_hash()).layers[0])
    theirs = [[int(v) for v in r] for r in np.asarray(theirs)]
    assert theirs == [j_poseidon2_host.hash_elements(r) for r in rows]
    assert all(t != JH.rpo_hash_elements_stateful(r) for t, r in zip(theirs, rows))
    mine = F.to_numpy(L.build_tree([_t(m)], hash=L.RPO_HASH).layers[0])
    assert [[int(v) for v in r] for r in mine] == [JH.rpo_hash_elements_stateful(r) for r in rows]
