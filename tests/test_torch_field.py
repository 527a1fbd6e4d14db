"""miden_tpu_torch.field ≡ miden_tpu.field (exact), on the CPU.

The same numpy u64 inputs go through ``miden_tpu.field.goldilocks`` (JAX on
the CPU), the exact Python-int oracle ``gl`` and the port's int64 torch ops;
every result must be equal, on random values and on the edge values 0, 1,
p−1, 2^32 and 2^64−2^32 (and 2^63 ± 1, which straddle the int64 sign bit).
"""

import numpy as np
import pytest
import torch

from miden_tpu.field import gl as jgl
from miden_tpu.field import goldilocks as J
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F

P = gl.P
EDGE = [0, 1, P - 1, 1 << 32, (1 << 64) - (1 << 32), 1 << 63, (1 << 63) - 1, P - 2, 7]


def _values(seed, n=256, nonzero=False):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([np.asarray(EDGE, dtype=np.uint64), rng.integers(0, P, n, dtype=np.uint64)])
    if nonzero:
        vals = vals[vals != 0]
    return vals


def _t(a):
    return F.to_torch(a, "cpu")


def test_edge_values_are_canonical_inputs():
    assert (1 << 64) - (1 << 32) == P - 1  # the largest field element
    assert all(int(v) < P for v in _values(0))


def test_converters_round_trip():
    a = _values(1)
    t = _t(a)
    assert t.dtype == torch.int64
    assert (F.to_numpy(t) == a).all()
    ja = J.fp_from_u64(a)  # miden_tpu's (lo, hi) u32 limb planes
    assert (F.to_numpy(F.from_lo_hi(np.asarray(ja.lo), np.asarray(ja.hi), "cpu")) == a).all()


BINARY = [
    ("add", F.add, J.fp_add, gl.add),
    ("sub", F.sub, J.fp_sub, gl.sub),
    ("mul", F.mul, J.fp_mul, gl.mul),
]


@pytest.mark.parametrize("name,port,jax_fn,oracle", BINARY, ids=[b[0] for b in BINARY])
def test_binary_ops(name, port, jax_fn, oracle):
    a = _values(2)
    b = np.random.default_rng(3).permutation(a)
    # every pair of edge values too
    ea, eb = np.meshgrid(np.asarray(EDGE[:-1], np.uint64), np.asarray(EDGE[:-1], np.uint64))
    a = np.concatenate([a, ea.ravel()]) % np.uint64(P)
    b = np.concatenate([b, eb.ravel()]) % np.uint64(P)
    got = F.to_numpy(port(_t(a), _t(b)))
    want = J.fp_to_u64(jax_fn(J.fp_from_u64(a), J.fp_from_u64(b)))
    assert (got == want).all()
    assert [int(v) for v in got] == [oracle(int(x), int(y)) for x, y in zip(a, b)]


UNARY = [
    ("neg", F.neg, J.fp_neg, gl.neg),
    ("double", F.double, J.fp_double, lambda x: gl.add(x, x)),
    ("square", F.square, J.fp_square, lambda x: gl.mul(x, x)),
    ("mul_2exp_7", lambda x: F.mul_2exp(x, 7), lambda x: J.fp_mul_2exp(x, 7), lambda x: gl.mul(x, 1 << 7)),
    ("mul_2exp_40", lambda x: F.mul_2exp(x, 40), lambda x: J.fp_mul_2exp(x, 40), lambda x: gl.mul(x, 1 << 40)),
    ("mul_small_7", lambda x: F.mul_small(x, 7), lambda x: J.fp_mul_small(x, 7), lambda x: gl.mul(x, 7)),
    ("pow_const_5", lambda x: F.pow_const(x, 5), lambda x: J.fp_pow_const(x, 5), lambda x: gl.pow_(x, 5)),
    ("exp_power_of_2_7", lambda x: F.exp_power_of_2(x, 7), lambda x: J.fp_exp_power_of_2(x, 7),
     lambda x: gl.exp_power_of_2(x, 7)),
]


@pytest.mark.parametrize("name,port,jax_fn,oracle", UNARY, ids=[u[0] for u in UNARY])
def test_unary_ops(name, port, jax_fn, oracle):
    a = _values(4)
    got = F.to_numpy(port(_t(a)))
    want = J.fp_to_u64(jax_fn(J.fp_from_u64(a)))
    assert (got == want).all()
    assert [int(v) for v in got] == [oracle(int(x)) for x in a]


@pytest.mark.parametrize("n", [1, 5, 64, 300])
def test_inverse_and_batch_inverse(n):
    a = _values(5, n, nonzero=True)[:n]
    got = F.to_numpy(F.inv(_t(a)))
    assert [int(v) for v in got] == [gl.inv(int(x)) for x in a]
    want = J.fp_to_u64(J.fp_inv(J.fp_from_u64(a)))
    assert (got == want).all()
    assert int(F.to_numpy(F.inv(_t(a)[0]).reshape(1))[0]) == gl.inv(int(a[0]))


def test_batch_inverse_along_axis0_with_trailing_axes():
    a = _values(6, 64, nonzero=True)[:48].reshape(16, 3)
    got = F.to_numpy(F.batch_inv(_t(a)))
    assert [[int(v) for v in r] for r in got] == [[gl.inv(int(x)) for x in r] for r in a]


@pytest.mark.parametrize("n,shift", [(1, 1), (7, 1), (64, 3), (100, P - 1)])
def test_powers(n, shift):
    base = 0x1234567890ABCDEF % P
    got = F.to_numpy(F.powers(base, n, shift=shift, device="cpu"))
    want = J.fp_to_u64(J.fp_powers(base, n, shift=shift))
    assert (got == want).all()
    assert int(got[-1]) == gl.mul(shift, gl.pow_(base, n - 1))


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_sum_axis0(n):
    a = _values(7, 3 * n)[: 3 * n].reshape(n, 3)
    got = F.to_numpy(F.sum_axis0(_t(a)))
    want = J.fp_to_u64(J.fp_sum_axis0(J.fp_from_u64(a)))
    assert (got == want).all()


def _ext_values(seed, n=64):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, P, (n, 2), dtype=np.uint64)
    pairs[0] = [0, 1]
    pairs[1] = [P - 1, P - 1]
    pairs[2] = [1 << 32, 0]
    return pairs


EXT = [
    ("ext_add", F.ext_add, J.fp2_add, jgl.ext_add),
    ("ext_sub", F.ext_sub, J.fp2_sub, jgl.ext_sub),
    ("ext_mul", F.ext_mul, J.fp2_mul, jgl.ext_mul),
]


@pytest.mark.parametrize("name,port,jax_fn,oracle", EXT, ids=[e[0] for e in EXT])
def test_ext_binary_ops(name, port, jax_fn, oracle):
    a, b = _ext_values(8), _ext_values(9)
    got = F.to_numpy(port(_t(a), _t(b)))
    want = J.fp2_to_pairs_u64(jax_fn(J.fp2_from_pairs_u64(a), J.fp2_from_pairs_u64(b)))
    assert (got == want).all()
    assert [tuple(int(v) for v in r) for r in got] == [
        oracle(tuple(int(v) for v in x), tuple(int(v) for v in y)) for x, y in zip(a, b)
    ]


def test_ext_mul_base_inv_square_exp_powers():
    a = _ext_values(10)
    s = _values(11)[: a.shape[0]]
    ja = J.fp2_from_pairs_u64(a)
    got = F.to_numpy(F.ext_mul_base(_t(a), _t(s)))
    assert (got == J.fp2_to_pairs_u64(J.fp2_mul_base(ja, J.fp_from_u64(s)))).all()
    nz = a[(a != 0).any(axis=1)]
    got = F.to_numpy(F.ext_inv(_t(nz)))
    assert (got == J.fp2_to_pairs_u64(J.fp2_inv(J.fp2_from_pairs_u64(nz)))).all()
    got = F.to_numpy(F.ext_exp_power_of_2(_t(a), 6))
    assert (got == J.fp2_to_pairs_u64(J.fp2_exp_power_of_2(ja, 6))).all()
    got = F.to_numpy(F.ext_neg(_t(a)))
    assert (got == J.fp2_to_pairs_u64(J.fp2_neg(ja))).all()
    base = _t(a[5])
    got = F.to_numpy(F.ext_powers(base, 37))
    want = J.fp2_to_pairs_u64(J.fp2_powers(J.fp2_from_pairs_u64(a[5]), 37))
    assert (got == want).all()
    got = F.to_numpy(F.ext_sum_axis0(_t(a)))
    assert (got == J.fp2_to_pairs_u64(J.fp2_sum_axis0(ja))).all()
