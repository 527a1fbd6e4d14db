"""miden_tpu_torch.ntt ≡ miden_tpu.ntt.ntt (exact), on the CPU.

Every transform of the port's ``ntt`` module is held equal to its JAX
counterpart on the same numpy inputs, over log n 1–12, widths 1/3/51/130 and
several coset shifts. The four-step decomposition that runs on the card over
kernels K1/K2 is forced at small n (its single-kernel limit is patched down,
as ``tests/test_ntt_pallas.py`` does on the JAX side) so that its split,
twiddles and transposes are exercised here with the kernels' plain twins.
"""

import numpy as np
import pytest

from miden_tpu.field.goldilocks import fp_from_u64, fp_to_u64
from miden_tpu.ntt import ntt as J
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.ntt import ntt as N

SHIFTS = [1, 7, gl.canonical_lde_shift(9), gl.P - 1]


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)


def _port(fn, x, *args):
    return F.to_numpy(fn(F.to_torch(x, "cpu"), *args))


_JAX_CACHE: dict = {}


def _jax(fn, x, *args):
    """JAX reference, memoized: eager JAX compiles every op per shape, so
    each reference is computed once per module."""
    key = (fn.__name__, x.shape, x.tobytes(), args)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = fp_to_u64(fn(fp_from_u64(x), *args))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("log_n", range(1, 13))
def test_dft_dif_dit_all_sizes(log_n):
    x = _rand(log_n, (1 << log_n, 3))
    assert (_port(N.dft_dif, x, False) == _jax(J.dft_dif, x, False)).all()
    assert (_port(N.dft_dit, x, True) == _jax(J.dft_dit, x, True)).all()


@pytest.mark.parametrize("width", [1, 3, 51, 130])
@pytest.mark.parametrize("log_n", [4, 6])
def test_dft_widths(log_n, width):
    x = _rand(100 + width, (1 << log_n, width))
    assert (_port(N.dft_dif, x) == _jax(J.dft_dif, x)).all()
    assert (_port(N.dft_dit, x, True) == _jax(J.dft_dit, x, True)).all()


@pytest.mark.parametrize("log_n", [1, 5, 8])
def test_bitrev_interpolate_evaluate(log_n):
    x = _rand(200 + log_n, (1 << log_n, 3))
    assert (_port(N.bitrev_perm, x) == _jax(J.bitrev_perm, x)).all()
    assert (_port(N.interpolate_bitrev, x) == _jax(J.interpolate_bitrev, x)).all()
    assert (_port(N.evaluate_natural, x) == _jax(J.evaluate_natural, x)).all()


@pytest.mark.parametrize("shift_out", SHIFTS)
def test_coset_lde_shifts(shift_out):
    x = _rand(3, (8, 2))
    assert (_port(N.coset_lde, x, 3, shift_out) == _jax(J.coset_lde, x, 3, shift_out)).all()
    got = _port(N.coset_lde, x, 3, shift_out, 3)
    assert (got == _jax(J.coset_lde, x, 3, shift_out, 3)).all()


@pytest.mark.parametrize("log_n,added,width", [(5, 1, 51), (4, 3, 16)])
def test_coset_lde_shapes(log_n, added, width):
    x = _rand(log_n * 7 + width, (1 << log_n, width))
    shift = gl.canonical_lde_shift(log_n + added)
    assert (_port(N.coset_lde, x, added, shift) == _jax(J.coset_lde, x, added, shift)).all()


@pytest.mark.parametrize("shift", SHIFTS)
def test_coset_interpolate_and_evaluate_on_coset(shift):
    x = _rand(17, (16, 4))
    coeffs = _port(N.coset_interpolate_bitrev, x, shift)
    assert (coeffs == _jax(J.coset_interpolate_bitrev, x, shift)).all()
    for added in (0, 2):
        got = _port(N.evaluate_coeffs_on_coset, coeffs, added, shift)
        assert (got == _jax(J.evaluate_coeffs_on_coset, coeffs, added, shift)).all()


@pytest.mark.parametrize("limit", [1, 2, 3])
@pytest.mark.parametrize("log_n", [2, 5, 8, 11])
def test_four_step_forced_at_small_n(monkeypatch, limit, log_n):
    """The card's four-step path (K1 sub-transforms + K2 twiddle-transposes, here
    their plain twins) equals the plain transform, with recursion when
    log n > 2·limit."""
    monkeypatch.setattr(N, "MAX_LOG_SINGLE", limit)
    x = _rand(log_n, (1 << log_n, 3))
    xt = F.to_torch(x, "cpu")
    for inverse in (False, True):
        got = F.to_numpy(N.four_step_dif(xt, inverse))
        assert (got == F.to_numpy(N.transform_plain(xt, inverse, dit=False))).all()
        assert (got == _jax(J.dft_dif, x, inverse)).all()
        got = F.to_numpy(N.four_step_dit(xt, inverse))
        assert (got == _jax(J.dft_dit, x, inverse)).all()


def test_stage_twiddles_match_the_pallas_tables():
    """K1's compact stage table holds the values of ntt_pallas._stage_tw_table."""
    from miden_tpu.ntt import ntt_pallas

    for log_n in (1, 4, 7):
        for inverse in (False, True):
            full = ntt_pallas._stage_tw_table(log_n, inverse)
            compact = F.to_numpy(N.stage_twiddles(log_n, inverse, "cpu"))
            n = 1 << log_n
            for s in range(log_n):
                half = n >> (s + 1)
                assert (compact[n - (n >> s) : n - (n >> s) + half] == full[s, :half]).all()


def test_outer_twiddles_match_the_pallas_table():
    from miden_tpu.ntt import ntt_pallas

    for inverse in (False, True):
        want = fp_to_u64(ntt_pallas.outer_twiddles(3, 4, inverse))
        assert (F.to_numpy(N.outer_twiddles(3, 4, inverse, "cpu")) == want).all()


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_transpose_twiddle_plain(mode):
    x = _rand(mode, (4, 8, 3))
    tw = _rand(10 + mode, (4, 8) if mode == 1 else (8, 4))
    got = F.to_numpy(N.transpose_twiddle(F.to_torch(x, "cpu"), F.to_torch(tw, "cpu"), mode))
    for b in range(8):
        for a in range(4):
            t = 1 if mode == 0 else int(tw[a, b] if mode == 1 else tw[b, a])
            assert [int(v) for v in got[b, a]] == [gl.mul(int(v), t) for v in x[a, b]]
