"""The port's CUDA kernels against their plain torch twins, on the card.

K1 (``ntt_col_transform``), K2 (``ntt_transpose_twiddle`` inside the
four-step decomposition), K3's three entries (``poseidon2_permute``,
``poseidon2_absorb_rows``, ``poseidon2_compress_rows``) and those of R1
(RPO-256) and R2 (RPX-256) are compared with
the plain versions on the same CUDA inputs, and ``MerkleTree`` folds its
lower layers on the card; Goldilocks arithmetic is exact, so every
comparison is exact equality. Every test skips without a card. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the repository's conftest configures JAX, which the card's
machine does not need.)
"""

import numpy as np
import pytest
import torch

from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.hash import poseidon2, poseidon2_host, rescue, rescue_host
from miden_tpu_torch.merkle import lmcs
from miden_tpu_torch.ntt import ntt
from miden_tpu_torch.utils import cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1-K3, R1 and R2 have no CPU mode)")


def _rand(rng, shape):
    return F.to_torch(rng.integers(0, gl.P, size=shape, dtype=np.uint64), "cuda")


def _equal(a, b):
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("n", [1, 1000, 1 << 16, 129])
def test_poseidon2_kernel_matches_plain(n):
    rng = np.random.default_rng(n)
    state = _rand(rng, (12, n))
    before = poseidon2.PERMUTE_KERNEL.launches
    out = poseidon2.permute(state)
    torch.cuda.synchronize()
    assert poseidon2.PERMUTE_KERNEL.launches == before + 1
    assert _equal(out, poseidon2.permute_plain(state))
    host = F.to_numpy(state[:, 0])
    assert [int(v) for v in F.to_numpy(out[:, 0])] == poseidon2_host.permute(
        [int(v) for v in host]
    )


@pytest.mark.parametrize("w", [1, 7, 8, 9, 22, 51, 64, 130])
@pytest.mark.parametrize("h,max_h", [(1, 1), (1, 8), (4, 4), (64, 256), (256, 1024), (1024, 1024)])
def test_absorb_rows_kernel_matches_plain(w, h, max_h):
    rng = np.random.default_rng(w * 7919 + h * 31 + max_h)
    state, m = _rand(rng, (12, max_h)), _rand(rng, (h, w))
    before = poseidon2.ABSORB_KERNEL.launches
    got = poseidon2.absorb_rows(state, m)
    torch.cuda.synchronize()
    assert poseidon2.ABSORB_KERNEL.launches == before + 1
    assert _equal(got, poseidon2.absorb_rows_plain(state, m))


@pytest.mark.parametrize("w", [3, 51])
def test_absorb_rows_kernel_unaligned_matrix(w):
    """A row-major view that starts off a 16-byte boundary takes the 8-byte
    copies."""
    rng = np.random.default_rng(w)
    big = _rand(rng, (257, w))
    m = big[1:]
    assert m.data_ptr() % 16 == 8 and m.is_contiguous()
    state = _rand(rng, (12, 512))
    assert _equal(poseidon2.absorb_rows_kernel(state, m), poseidon2.absorb_rows_plain(state, m))


@pytest.mark.parametrize("m", [1, 127, 1000, 1 << 14])
def test_compress_rows_kernel_matches_plain(m):
    cur = _rand(np.random.default_rng(m), (2 * m, 4))
    before = poseidon2.COMPRESS_KERNEL.launches
    got = poseidon2.compress_rows(cur)
    torch.cuda.synchronize()
    assert poseidon2.COMPRESS_KERNEL.launches == before + 1
    assert _equal(got, poseidon2.compress_rows_plain(cur))
    left, right = cur[0::2].contiguous(), cur[1::2].contiguous()
    assert _equal(poseidon2.compress_pairs(left, right), got)


def test_lmcs_tree_on_card_goes_through_the_row_kernels():
    rng = np.random.default_rng(5)
    shapes = [(1024, 51), (256, 22), (64, 16), (1024, 0)]
    mats = [_rand(rng, s) for s in shapes]
    counts = [k.launches for k in (poseidon2.PERMUTE_KERNEL, poseidon2.ABSORB_KERNEL, poseidon2.COMPRESS_KERNEL)]
    tree = lmcs.build_tree(mats)
    torch.cuda.synchronize()
    after = [k.launches for k in (poseidon2.PERMUTE_KERNEL, poseidon2.ABSORB_KERNEL, poseidon2.COMPRESS_KERNEL)]
    assert [a - b for a, b in zip(after, counts)] == [0, 3, 10]
    ref = lmcs.build_tree([m.cpu() for m in mats])
    for mine, theirs in zip(tree.layers, ref.layers):
        assert torch.equal(mine.cpu(), theirs)


@pytest.mark.parametrize("log_n", range(1, ntt.MAX_LOG_SINGLE + 1))
@pytest.mark.parametrize("width", [1, 3, 51, 130, 17, 300])
def test_col_transform_kernel_matches_plain(log_n, width):
    rng = np.random.default_rng(log_n * 1000 + width)
    x = _rand(rng, (1 << log_n, width))
    for dit in (False, True):
        for inverse in (False, True):
            got = ntt.col_transform_kernel(x, inverse, dit)
            assert _equal(got, ntt.transform_plain(x, inverse, dit)), (dit, inverse)


@pytest.mark.parametrize("log_n", [10, 11])
@pytest.mark.parametrize("width", [4000, 5001])
def test_col_transform_kernel_unaligned_input(log_n, width):
    """A row-major view that starts off a 16-byte boundary (and an odd width)
    takes K1's 8-byte copies; more tiles than SMs keep the ring busy."""
    rng = np.random.default_rng(log_n + width)
    big = _rand(rng, ((1 << log_n) * width + 1,))
    x = big[1:].reshape(1 << log_n, width)
    assert x.data_ptr() % 16 == 8 and x.is_contiguous()
    for dit in (False, True):
        got = ntt.col_transform_kernel(x, False, dit)
        assert _equal(got, ntt.transform_plain(x, False, dit)), dit


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_transpose_twiddle_kernel_matches_plain(mode):
    rng = np.random.default_rng(mode)
    x = _rand(rng, (64, 32, 5))
    tw = _rand(rng, (64, 32) if mode == 1 else (32, 64))
    got = ntt.transpose_twiddle_kernel(x, tw, mode)
    assert _equal(got, ntt.transpose_twiddle_plain(x, tw, mode))


@pytest.mark.parametrize("log_n", [13, 16, 19])
def test_four_step_on_card_matches_plain(log_n):
    rng = np.random.default_rng(log_n)
    x = _rand(rng, (1 << log_n, 16))
    for inverse in (False, True):
        assert _equal(ntt.dft_dif(x, inverse), ntt.transform_plain(x, inverse, dit=False))
        assert _equal(ntt.dft_dit(x, inverse), ntt.transform_plain(x, inverse, dit=True))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        poseidon2.absorb_rows_kernel(
            torch.zeros((12, 8), dtype=torch.int64, device="cuda"),
            torch.zeros((3, 2), dtype=torch.int64, device="cuda"),
        )  # height not a power of two
    with pytest.raises(ValueError):
        poseidon2.compress_rows_kernel(torch.zeros((3, 4), dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError):
        poseidon2.compress_rows_kernel(
            torch.zeros(17, dtype=torch.int64, device="cuda")[1:].reshape(4, 4)
        )  # 8 bytes off a 16-byte boundary
    with pytest.raises(ValueError):
        poseidon2.permute_kernel(torch.zeros((12, 4), dtype=torch.int64))  # CPU tensor
    with pytest.raises(ValueError):
        poseidon2.permute_kernel(torch.zeros((12, 4), dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError):
        ntt.col_transform_kernel(
            torch.zeros((1 << (ntt.MAX_LOG_SINGLE + 1), 1), dtype=torch.int64, device="cuda"),
            False,
            False,
        )
    with pytest.raises(ValueError):
        ntt.col_transform_kernel(torch.zeros((8, 6), dtype=torch.int64, device="cuda")[:, ::2], False, False)


def test_build_is_idempotent():
    cuda.build_all()
    assert cuda.build_all() < 5.0  # nothing stale: no nvcc runs


RESCUE = {"rpo": (rescue.RPO, rescue_host.rpo_permute, lmcs.RPO_HASH),
          "rpx": (rescue.RPX, rescue_host.rpx_permute, lmcs.RPX_HASH)}


@pytest.mark.parametrize("which", ["rpo", "rpx"])
@pytest.mark.parametrize("n", [1, 129, 1000])
def test_rescue_permute_kernel_matches_plain(which, n):
    sponge, host, _ = RESCUE[which]
    state = _rand(np.random.default_rng(n), (12, n))
    before = sponge.PERMUTE_KERNEL.launches
    out = sponge.permute(state)
    torch.cuda.synchronize()
    assert sponge.PERMUTE_KERNEL.launches == before + 1
    assert _equal(out, sponge.permute_plain(state))
    col = [int(v) for v in F.to_numpy(state[:, n - 1])]
    assert [int(v) for v in F.to_numpy(out[:, n - 1])] == host(col)


@pytest.mark.parametrize("which", ["rpo", "rpx"])
@pytest.mark.parametrize("h,max_h,w", [(1, 1, 3), (1, 8, 8), (64, 256, 51), (1024, 1024, 9)])
def test_rescue_absorb_rows_kernel_matches_plain(which, h, max_h, w):
    sponge = RESCUE[which][0]
    rng = np.random.default_rng(h * 31 + max_h + w)
    state, m = _rand(rng, (12, max_h)), _rand(rng, (h, w))
    before = sponge.ABSORB_KERNEL.launches
    got = sponge.absorb_rows(state, m)
    torch.cuda.synchronize()
    assert sponge.ABSORB_KERNEL.launches == before + 1
    assert _equal(got, sponge.absorb_rows_plain(state, m))


@pytest.mark.parametrize("which", ["rpo", "rpx"])
@pytest.mark.parametrize("m", [1, 1000])
def test_rescue_compress_rows_kernel_matches_plain(which, m):
    sponge = RESCUE[which][0]
    cur = _rand(np.random.default_rng(m), (2 * m, 4))
    before = sponge.COMPRESS_KERNEL.launches
    got = sponge.compress_rows(cur)
    torch.cuda.synchronize()
    assert sponge.COMPRESS_KERNEL.launches == before + 1
    assert _equal(got, sponge.compress_rows_plain(cur))


@pytest.mark.parametrize("which", ["rpo", "rpx"])
def test_rescue_tree_on_card_goes_through_its_row_kernels(which):
    sponge, _, config = RESCUE[which]
    rng = np.random.default_rng(6)
    mats = [_rand(rng, s) for s in [(256, 51), (64, 22), (256, 0)]]
    kernels = (sponge.PERMUTE_KERNEL, sponge.ABSORB_KERNEL, sponge.COMPRESS_KERNEL)
    counts = [k.launches for k in kernels]
    tree = lmcs.build_tree(mats, hash=config)
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == [0, 2, 8]
    ref = lmcs.build_tree([m.cpu() for m in mats], hash=config)
    for mine, theirs in zip(tree.layers, ref.layers):
        assert torch.equal(mine.cpu(), theirs)


def test_merkle_tree_on_the_card_folds_with_compress_rows():
    from miden_tpu_torch.merkle import MerkleTree

    rng = np.random.default_rng(11)
    leaves = [tuple(int(v) for v in row) for row in rng.integers(0, gl.P, size=(1 << 11, 4), dtype=np.uint64)]
    before = poseidon2.COMPRESS_KERNEL.launches
    tree = MerkleTree(leaves)  # the card by default
    assert poseidon2.COMPRESS_KERNEL.launches == before + 2  # 2^11 -> 2^10 -> 2^9 rows
    cpu = MerkleTree(leaves, device="cpu")
    assert tree.root == cpu.root and list(tree.inner_nodes()) == list(cpu.inner_nodes())
