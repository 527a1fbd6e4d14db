"""The port's byte hashes ≡ ``miden_tpu``'s (exact), on the CPU.

``miden_tpu_torch.hash.blake3`` / ``keccak`` (plain torch on int64 words)
against ``miden_tpu.hash.blake3`` / ``keccak`` called eagerly (never jitted:
XLA:CPU takes minutes per byte-hash shape), the port's ``sha2`` and
``stateful`` hashers against ``miden_tpu``'s on the cases of
``tests/test_byte_hashes.py``, and the BLAKE3-256 / Keccak-256 LMCS
configurations: roots equal to trees folded from ``miden_tpu``'s host
twins, openings accepted by both packages' verifiers, a tampered row
rejected. Byte hashes are exact, so the tolerance is 0.
"""

import hashlib

import numpy as np
import pytest
import torch

from miden_tpu.hash import blake3 as j_blake3
from miden_tpu.hash import keccak as j_keccak
from miden_tpu.hash import sha2 as j_sha2
from miden_tpu.hash import stateful as j_stateful
from miden_tpu.merkle import lmcs as JL
from miden_tpu.transcript import challenger as JC
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.hash import blake3, blake3_host, keccak, keccak_host, poseidon2_host, sha2, stateful
from miden_tpu_torch.merkle import lmcs as L
from miden_tpu_torch.transcript import challenger as C

BYTE_HASHES = {"blake3_256": (blake3, j_blake3, JL.blake3_hash), "keccak256": (keccak, j_keccak, JL.keccak_hash)}
SEED = [0x6D75, 0x6C74, 0x6968, 0x6173]


def _rows(seed, shape):
    return np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)


def _lo_hi(arr):
    import jax.numpy as jnp

    return jnp.asarray((arr & 0xFFFFFFFF).astype(np.uint32)), jnp.asarray((arr >> 32).astype(np.uint32))


@pytest.mark.parametrize("name", sorted(BYTE_HASHES))
@pytest.mark.parametrize("w", [1, 7, 8, 51, 73])
def test_hash_felt_rows_equal_miden_tpu(name, w):
    mine, theirs, _ = BYTE_HASHES[name]
    arr = _rows(w, (5, w))
    got = mine.hash_felt_rows(F.to_torch(arr, "cpu"))
    want = np.asarray(theirs.hash_felt_rows(*_lo_hi(arr)))
    assert got.shape == (5, 8) and (got.numpy() == want).all()
    host = blake3_host if name == "blake3_256" else keccak_host
    assert mine.digests_to_bytes(got) == [host.hash_elements([int(v) for v in r]) for r in arr]


@pytest.mark.parametrize("name", sorted(BYTE_HASHES))
def test_compress_pairs_equal_miden_tpu(name):
    import jax.numpy as jnp

    mine, theirs, _ = BYTE_HASHES[name]
    rng = np.random.default_rng(12)
    d1, d2 = (np.frombuffer(rng.bytes(5 * 32), dtype="<u4").reshape(5, 8).copy() for _ in range(2))
    got = mine.compress_pairs(*(torch.from_numpy(d.astype(np.int64)) for d in (d1, d2)))
    want = np.asarray(theirs.compress_pairs(jnp.asarray(d1), jnp.asarray(d2)))
    assert (got.numpy() == want).all()
    assert mine.digests_to_bytes(got) == theirs.digests_to_bytes(want)


def test_sha2_equals_miden_tpu():
    data = b"miden on tpu"
    assert sha2.sha256(data) == j_sha2.sha256(data) == hashlib.sha256(data).digest()
    assert sha2.hash_elements([1, 2, 3]) == j_sha2.hash_elements([1, 2, 3])
    left, right = sha2.sha256(b"l"), sha2.sha256(b"r")
    assert sha2.merge(left, right) == j_sha2.merge(left, right)


def test_stateful_sponge_equals_miden_tpu():
    rows = [[1, 2, 3], list(range(10, 22)), [7], [gl.P + 5]]
    got = stateful.StatefulSponge().hash_rows(rows)
    assert got == j_stateful.StatefulSponge().hash_rows(rows)
    state = [0] * 12
    for row in rows:
        poseidon2_host.absorb(state, [v % gl.P for v in row])
    assert got == tuple(state[:4])
    sponge = stateful.StatefulSponge()
    st = sponge.new_state()
    for row in rows:
        sponge.absorb_into(st, row)
    assert sponge.squeeze(st) == got


def test_serializing_chaining_truncating_equal_miden_tpu():
    for mod in (stateful, j_stateful):
        ser = mod.SerializingStatefulSponge(hashlib.sha256)
        st = ser.new_state()
        ser.absorb_into(st, [1, 2])
        assert ser.squeeze(st) == hashlib.sha256((1).to_bytes(8, "little") + (2).to_bytes(8, "little")).digest()
    outs = []
    for mod in (stateful, j_stateful):
        chain = mod.ChainingHasher(lambda b: hashlib.sha256(b).digest())
        st = chain.new_state()
        chain.absorb_into(st, [3])
        chain.absorb_into(st, [4])
        outs.append(chain.squeeze(st))
        trunc = mod.TruncatingHasher(mod.StatefulSponge(), 3)
        outs.append(trunc.hash_rows([[5, 6]]))
        assert trunc.alignment == 8
    h1 = hashlib.sha256((3).to_bytes(8, "little")).digest()
    assert outs[0] == outs[2] == hashlib.sha256(h1 + (4).to_bytes(8, "little")).digest()
    assert outs[1] == outs[3] == stateful.StatefulSponge().hash_rows([[5, 6]])[:3]


SHAPES = [[(16, 5), (4, 3)], [(32, 51), (8, 22), (2, 16)], [(8, 0), (8, 9)], [(1, 8)]]


def _host_tree_root(cfg, mats):
    """The root of a tree folded from ``miden_tpu``'s host twins over the
    lifted, padded rows."""
    max_h = max(m.shape[0] for m in mats)
    layer = []
    for d in range(max_h):
        row = []
        for m in mats:
            r = [int(v) for v in m[d % m.shape[0]]]
            row += r + [0] * (L.aligned_width(len(r)) - len(r))
        layer.append(cfg.host_hash_elements(row))
    while len(layer) > 1:
        layer = [cfg.host_compress(list(layer[i]), list(layer[i + 1])) for i in range(0, len(layer), 2)]
    return [int(v) for v in layer[0]]


@pytest.mark.parametrize("name", sorted(BYTE_HASHES))
@pytest.mark.parametrize("shapes", SHAPES, ids=[str(s) for s in SHAPES])
def test_byte_hash_root_equals_a_tree_of_miden_tpu_host_twins(name, shapes):
    mats = [_rows(i + 20, s) for i, s in enumerate(shapes)]
    tree = L.build_tree([F.to_torch(m, "cpu") for m in mats], hash=L.HASH_CONFIGS[name]())
    assert [int(v) for v in tree.root()] == _host_tree_root(BYTE_HASHES[name][2](), mats)


def _open(tree, raw):
    ch = C.ProverChannel(C.DuplexChallenger(SEED))
    flat, meta = L.gather_query_data(tree, torch.tensor(raw, dtype=torch.int64))
    L.emit_opening_hints(ch, F.to_numpy(flat), meta, raw)
    return ch.finalize()[1]


@pytest.mark.parametrize("name", sorted(BYTE_HASHES))
def test_byte_hash_openings_accepted_by_both_verifiers(name):
    shapes = SHAPES[1]
    mats = [_rows(i + 40, s) for i, s in enumerate(shapes)]
    cfg, j_cfg = L.HASH_CONFIGS[name](), BYTE_HASHES[name][2]()
    tree = L.build_tree([F.to_torch(m, "cpu") for m in mats], hash=cfg)
    raw = [0, 5, 5, 31, 12, 7]
    data = _open(tree, raw)
    widths = [w for _, w in shapes]
    root = tree.root()
    mine = L.verify_batch(root, widths, 32, raw, C.VerifierChannel(data, C.DuplexChallenger(SEED)), hash=cfg)
    theirs = JL.verify_batch(
        root, widths, 32, raw,
        JC.VerifierChannel(JC.TranscriptData(data.fields, data.commitments), JC.DuplexChallenger(SEED)),
        hash=j_cfg,
    )
    for d in set(raw):
        for (h, _), m, r, r2 in zip(shapes, mats, mine[d], theirs[d]):
            assert (r == m[d % h]).all() and (r2 == m[d % h]).all()

    data.fields[3] = (data.fields[3] + 1) % gl.P
    with pytest.raises(ValueError):
        L.verify_batch(root, widths, 32, raw, C.VerifierChannel(data, C.DuplexChallenger(SEED)), hash=cfg)
    with pytest.raises(ValueError):
        JL.verify_batch(
            root, widths, 32, raw,
            JC.VerifierChannel(JC.TranscriptData(data.fields, data.commitments), JC.DuplexChallenger(SEED)),
            hash=j_cfg,
        )


def test_pipeline_rejects_byte_hashes():
    """They serve as data commitments only, as in ``miden_tpu``."""
    import dataclasses

    from miden_tpu_torch.stark import TEST_PARAMS

    for name in sorted(BYTE_HASHES):
        with pytest.raises(AssertionError):
            dataclasses.replace(TEST_PARAMS, hash_name=name)
