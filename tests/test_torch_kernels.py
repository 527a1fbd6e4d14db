"""The port's CUDA kernels against their plain torch twins, on the card.

K1 (``ntt_col_transform``), K2 (``ntt_transpose_twiddle`` inside the
four-step decomposition) and K3 (``poseidon2_permute``) are compared with the plain
versions on the same CUDA inputs; Goldilocks arithmetic is exact, so every
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
from miden_tpu_torch.hash import poseidon2, poseidon2_host
from miden_tpu_torch.ntt import ntt
from miden_tpu_torch.utils import cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1-K3 have no CPU mode)")


def _rand(rng, shape):
    return F.to_torch(rng.integers(0, gl.P, size=shape, dtype=np.uint64), "cuda")


def _equal(a, b):
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
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


@pytest.mark.parametrize("log_n", range(1, ntt.MAX_LOG_SINGLE + 1))
@pytest.mark.parametrize("width", [1, 3, 51, 130])
def test_col_transform_kernel_matches_plain(log_n, width):
    rng = np.random.default_rng(log_n * 1000 + width)
    x = _rand(rng, (1 << log_n, width))
    for dit in (False, True):
        for inverse in (False, True):
            got = ntt.col_transform_kernel(x, inverse, dit)
            assert _equal(got, ntt.transform_plain(x, inverse, dit)), (dit, inverse)


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
