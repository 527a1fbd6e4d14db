"""Batched RPO-256 / RPX-256 permutations (width 12, Goldilocks) on torch
tensors, laid out like :mod:`.poseidon2`.

The state is one int64 tensor of shape ``(12, n)``, the caller layout of
``miden_tpu.hash.rescue.rpo_permute`` / ``rpx_permute``. :data:`RPO` and
:data:`RPX` are the three entries of :class:`~.sponge.Sponge` (``permute``,
``absorb_rows``, ``compress_rows``) over :func:`rpo_permute_plain` and
:func:`rpx_permute_plain`, with kernels R1 and R2 (``csrc/rescue.cu``) for
CUDA tensors and the plain twins for CPU tensors. The LMCS ``rpo256`` /
``rpx256`` configurations commit through them (rate lanes 0..8, capacity
8..12, digest 0..4, as ``rescue_host._hash_elements_overwrite``).

Structure (``miden_tpu/hash/rescue.py``; reference
crates/crypto/src/hash/algebraic_sponge/rescue/):

- MDS: the 12x12 circulant with entries ≤ 26, as multiply-adds of small
  constants on the 32-bit halves of each lane, one reduction per output;
- x^7: 4 products a lane; x^{1/7}: the reference's 72-product addition
  chain (rescue/mod.rs apply_inv_sbox);
- RPX's E round: x^7 in F_p[φ]/(φ³ − φ − 1) on four 3-lane chunks, and the
  final M + ARK1[6].
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gl
from ..field import goldilocks as F
from . import rescue_constants as RC
from .sponge import Sponge

INV_ALPHA = 10540996611094048183  # 7^-1 mod (p - 1)

_M32 = 0xFFFFFFFF
_EPS = 0xFFFFFFFF  # 2^64 mod p

_CONSTS: dict = {}  # device -> (ARK1 (7, 12, 1), ARK2 (7, 12, 1))


def _arks(device):
    key = str(device)
    if key not in _CONSTS:
        _CONSTS[key] = tuple(
            F.to_torch([[[v] for v in row] for row in ark], device) for ark in (RC.ARK1, RC.ARK2)
        )
    return _CONSTS[key]


def _mds(s):
    """``out[i] = Σ_k MDS_ROW0[k]·s[(i + k) mod 12]`` on (12, n): the sums
    over the low and the high 32-bit halves of the lanes stay below 2^41, so
    ``out = a + b·2^32`` is reduced once, with ``b·2^32 = (b mod 2^32)·2^32 +
    (b >> 32)·2^64`` and ``2^64 ≡ 2^32 − 1``."""
    lo, hi = s & _M32, F._shr32(s)
    a = b = None
    for k, c in enumerate(RC.MDS_ROW0):
        lo_k, hi_k = torch.roll(lo, -k, dims=0), torch.roll(hi, -k, dims=0)
        a = c * lo_k if a is None else a + c * lo_k
        b = c * hi_k if b is None else b + c * hi_k
    bh = b >> 32  # b < 2^41: the arithmetic shift is exact
    # (b mod 2^32)·2^32 ≤ 2^64 − 2^32 < p, a < 2^41 and bh·EPS < 2^41 are canonical
    return F.add(F.add((b & _M32) << 32, a), bh * _EPS)


def _sbox(x):
    x2 = F.square(x)
    x4 = F.square(x2)
    return F.mul(x4, F.mul(x2, x))


def _exp_acc(base, m: int, tail):
    """base^(2^m)·tail"""
    return F.mul(F.exp_power_of_2(base, m), tail)


def _inv_sbox(x):
    """x^{1/7} = x^INV_ALPHA in 72 products (the chain of ``csrc/rescue.cu``)."""
    t1 = F.square(x)
    t2 = F.square(t1)
    t3 = _exp_acc(t2, 3, t2)
    t4 = _exp_acc(t3, 6, t3)
    t5 = _exp_acc(t4, 12, t4)
    t6 = _exp_acc(t5, 6, t3)
    t7 = _exp_acc(t6, 31, t6)
    a = F.square(F.square(F.mul(F.square(t7), t6)))
    return F.mul(a, F.mul(F.mul(t1, t2), x))


def _fb_round(s, ark1, ark2):
    s = _sbox(F.add(_mds(s), ark1))
    return _inv_sbox(F.add(_mds(s), ark2))


def _c3_mul(a, b):
    """Products in F_p[φ]/(φ³ − φ − 1) of (3, ...) coefficient stacks, with
    φ³ = φ + 1 and φ⁴ = φ² + φ."""
    p = [[F.mul(a[i], b[j]) for j in range(3)] for i in range(3)]
    c3 = F.add(p[1][2], p[2][1])
    return torch.stack([
        F.add(p[0][0], c3),
        F.add(F.add(p[0][1], p[1][0]), F.add(c3, p[2][2])),
        F.add(F.add(p[0][2], p[1][1]), F.add(p[2][0], p[2][2])),
    ])


def _c3_pow7(a):
    a2 = _c3_mul(a, a)
    a3 = _c3_mul(a2, a)
    return _c3_mul(_c3_mul(a3, a3), a)


def _ext_round(s, ark1):
    """+ARK1, then x^7 on the four 3-lane chunks, all chunks at once."""
    s = F.add(s, ark1)
    n = s.shape[1]
    chunks = s.reshape(4, 3, n).transpose(0, 1)  # (3 coefficients, 4 chunks, n)
    return _c3_pow7(chunks).transpose(0, 1).reshape(12, n)


def rpo_permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain torch RPO on ``(12, n)`` int64 states (any device)."""
    assert state.shape[0] == 12
    ark1, ark2 = _arks(state.device)
    s = state
    for r in range(RC.NUM_ROUNDS):
        s = _fb_round(s, ark1[r], ark2[r])
    return s


def rpx_permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain torch RPX (XHash12) on ``(12, n)`` int64 states (any device):
    (FB)(E)(FB)(E)(FB)(E)(M)."""
    assert state.shape[0] == 12
    ark1, ark2 = _arks(state.device)
    s = state
    for r in (0, 2, 4):
        s = _ext_round(_fb_round(s, ark1[r], ark2[r]), ark1[r + 1])
    return F.add(_mds(s), ark1[6])


#: R1, RPO-256 (miden_tpu computes it in XLA: miden_tpu/hash/rescue.py `rpo_permute`)
RPO = Sponge("rpo", "rescue", "Rpo", rpo_permute_plain)
#: R2, RPX-256 (miden_tpu/hash/rescue.py `rpx_permute`)
RPX = Sponge("rpx", "rescue", "Rpx", rpx_permute_plain)

rpo_permute = RPO.permute
rpx_permute = RPX.permute


# ---------------------------------------------------------------------------
# Edge states: the check of R1 / R2 that uniform random states rarely reach
# ---------------------------------------------------------------------------

#: canonical values that reach the carry and borrow paths of the kernels'
#: squares, reductions and lazy sums: 0, 1, p - 1 (high 32-bit half all
#: ones), p - 2, 2^32 - 1 (low half all ones), 2^32, 2^48 (whose square is
#: 2^96), 2^63 - 1 and 2^63
EDGE_VALUES = (0, 1, 2**64 - 2**32, 2**64 - 2**32 - 1, 2**32 - 1, 2**32, 2**48, 2**63 - 1, 2**63)


def edge_states() -> np.ndarray:
    """(12, n) uint64 states of EDGE_VALUES: one with all 12 lanes equal
    per value, and mixed ones (lane i of state j holds value (i + j) mod k
    or (i * (j + 1)) mod k of the k values, or two values alternating)."""
    k = len(EDGE_VALUES)
    cols = [[v] * 12 for v in EDGE_VALUES]
    cols += [[EDGE_VALUES[(i + j) % k] for i in range(12)] for j in range(k)]
    cols += [[EDGE_VALUES[(i * (j + 1)) % k] for i in range(12)] for j in range(k)]
    cols += [[EDGE_VALUES[j if i % 2 else (j + 1) % k] for i in range(12)] for j in range(k)]
    return np.array(cols, dtype=np.uint64).T.copy()


def hold_edge_states(sponge, host_permute, device: str) -> dict:
    """Holds the three entries of ``sponge`` (:data:`RPO` / :data:`RPX`) on
    ``device`` to their plain twins and to ``host_permute`` (the exact
    int permutation of ``hash.rescue_host``) on :func:`edge_states`: permute
    on the edge states; absorb_rows on those states (padded to 64 with
    seeded ones) and a (16, 19) matrix of edge values (three rate blocks,
    the last ragged, each state taking row j mod 16); compress_rows on 128
    rows of edge values. Returns {entry: max |diff| against both}."""
    k = edge_states()
    pad = np.random.default_rng(64).integers(0, gl.P, size=(12, 64 - k.shape[1]), dtype=np.uint64)
    states = np.concatenate([k, pad], axis=1)
    mat = np.resize(np.array(EDGE_VALUES, dtype=np.uint64), (16, 19))
    cur = states.T.reshape(-1, 4)[:128].copy()

    def err(got, *wants) -> int:
        g = F.to_numpy(got).astype(object)
        return max(int(abs(g - np.asarray(w, dtype=np.uint64).astype(object)).max()) for w in wants)

    cols = lambda a: [[int(v) for v in a[:, j]] for j in range(a.shape[1])]  # noqa: E731
    host_perm = np.array([host_permute(c) for c in cols(k)], dtype=np.uint64).T
    host_absorb = []
    for j, col in enumerate(cols(states)):
        row = [int(v) for v in mat[j % 16]]
        for c0 in range(0, 19, 8):
            block = row[c0 : c0 + 8]
            col = host_permute(block + [0] * (8 - len(block)) + col[8:])
        host_absorb.append(col)
    host_compress = [host_permute([int(v) for v in cur[2 * i]] + [int(v) for v in cur[2 * i + 1]]
                                  + [0] * 4)[:4] for i in range(64)]
    t = lambda a: F.to_torch(a, device)  # noqa: E731
    return {
        "permute": err(sponge.permute_kernel(t(k)), F.to_numpy(sponge.permute_plain(t(k))), host_perm),
        "absorb_rows": err(sponge.absorb_rows_kernel(t(states), t(mat)),
                           F.to_numpy(sponge.absorb_rows_plain(t(states), t(mat))),
                           np.array(host_absorb, dtype=np.uint64).T),
        "compress_rows": err(sponge.compress_rows_kernel(t(cur)),
                             F.to_numpy(sponge.compress_rows_plain(t(cur))),
                             np.array(host_compress, dtype=np.uint64)),
    }
