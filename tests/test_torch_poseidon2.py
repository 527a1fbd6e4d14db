"""miden_tpu_torch.hash.poseidon2 ≡ miden_tpu.hash.poseidon2 (exact), on the CPU.

The port's plain permutation (the CPU twin of kernel K3) is held equal to
the JAX permutation and to the exact host permutation on the same numpy
states, to the reference test vector pinned in ``tests/test_poseidon2.py``,
and the sponge choreography (``hash_blocks``, ``compress_pairs``) to the JAX
functions.
"""

import numpy as np
import pytest

from miden_tpu.field.goldilocks import fp_from_u64, fp_to_u64
from miden_tpu.hash import poseidon2 as J
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.hash import poseidon2 as P2
from miden_tpu_torch.hash import poseidon2_host

EXPECTED_PERM_0_11 = [
    0xF292AB67C0F14B03, 0x0A32F1B37656544C, 0x053C61AB895498DE, 0x02FF92E55B196FFB,
    0x58176E8F6F58CAB2, 0xB0AA1206E7AEC0F8, 0xE90C13F3DCE83CA4, 0xF4DA15333EDF39C2,
    0x23B701C053C2CA6C, 0xD233D593DCDFBF58, 0x4EFFA5F9516FB52E, 0x0AAF4489F1F40166,
]


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)


def test_permutation_vector():
    out = P2.permute(F.to_torch(np.arange(12, dtype=np.uint64)[:, None], "cpu"))
    assert [int(v) for v in F.to_numpy(out[:, 0])] == EXPECTED_PERM_0_11


@pytest.mark.parametrize("n", [1, 5, 64, 1000])
def test_permute_matches_jax_and_host(n):
    states = _rand(n, (12, n))
    states[:, 0] = [0, 1, gl.P - 1, 1 << 32, gl.P - 2, 7, 0, 0, 1 << 63, 5, 6, 7]
    got = F.to_numpy(P2.permute(F.to_torch(states, "cpu")))
    assert (got == fp_to_u64(J.permute_jit(fp_from_u64(states)))).all()
    for j in range(min(n, 8)):
        assert [int(v) for v in got[:, j]] == poseidon2_host.permute([int(v) for v in states[:, j]])


def test_permute_plain_is_the_cpu_path():
    states = F.to_torch(_rand(9, (12, 17)), "cpu")
    assert (F.to_numpy(P2.permute(states)) == F.to_numpy(P2.permute_plain(states))).all()


@pytest.mark.parametrize("n_leaves,n_blocks", [(1, 1), (16, 3), (33, 7)])
def test_hash_blocks_matches_jax(n_leaves, n_blocks):
    blocks = _rand(n_leaves * 10 + n_blocks, (n_leaves, n_blocks, 8))
    got = F.to_numpy(P2.hash_blocks(F.to_torch(blocks, "cpu")))
    assert got.shape == (n_leaves, 4)
    assert (got == fp_to_u64(J.hash_blocks_jit(fp_from_u64(blocks)))).all()
    row = [int(v) for v in blocks[0].reshape(-1)]
    assert [int(v) for v in got[0]] == poseidon2_host.hash_elements(row)


@pytest.mark.parametrize("n", [1, 8, 100])
def test_compress_pairs_matches_jax(n):
    left, right = _rand(n, (n, 4)), _rand(n + 1, (n, 4))
    got = F.to_numpy(P2.compress_pairs(F.to_torch(left, "cpu"), F.to_torch(right, "cpu")))
    want = fp_to_u64(J.compress_pairs_jit(fp_from_u64(left), fp_from_u64(right)))
    assert (got == want).all()
    assert [int(v) for v in got[0]] == poseidon2_host.compress(
        [int(v) for v in left[0]], [int(v) for v in right[0]]
    )
