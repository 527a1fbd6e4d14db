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
from miden_tpu_torch.hash.rescue import EDGE_VALUES
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


# ---------------------------------------------------------------------------
# CPU rehearsal of the arithmetic of csrc/rescue.cu: Python-integer models of
# the kernel's steps, written limb by limb as the CUDA does them (32-bit
# carry chains, 64-bit registers that wrap), held to exact integer results
# on the edge values and on 10^4 seeded values each.
# ---------------------------------------------------------------------------

M32, M64 = 2**32 - 1, 2**64 - 1
EPS = 2**32 - 1
#: operands of the models: canonical edge values and 64-bit values above p
#: (the reductions' outputs are below 2^64, not always canonical)
MODEL_EDGES = sorted(set(EDGE_VALUES) | {P, P + 1, M64, M64 - 1, 2**64 - 2**33, 2**16, 2**32 + 1,
                                         2**33 - 2, EPS << 32, 2**62})


def _seeded_u64(seed: int, n: int = 10_000, below: int = 2**64) -> list:
    rng = np.random.default_rng(seed)
    return [int(v) % below for v in rng.integers(0, 2**64, size=n, dtype=np.uint64)]


def _sub_wrap(a, b):
    """gl::sub_wrap: a - b, and EPS less when it borrows."""
    return ((a - b) - (EPS if a < b else 0)) & M64


def _sqr_wide(a):
    """gl::sqr_wide: x = a0², c = a0·a1, y = a1² (64-bit partial products),
    then the cross term added twice through the 32-bit carry chain
    (addc.u32 drops its carry out)."""
    a0, a1 = a & M32, a >> 32
    x, c, y = a0 * a0, a0 * a1, a1 * a1
    r0, r1 = x & M32, x >> 32
    c0, c1, y0, y1 = c & M32, c >> 32, y & M32, y >> 32
    t = r1 + c0
    r1, cy = t & M32, t >> 32
    t = y0 + c1 + cy
    r2, cy = t & M32, t >> 32
    r3 = (y1 + cy) & M32
    t = r1 + c0
    r1, cy = t & M32, t >> 32
    t = r2 + c1 + cy
    r2, cy = t & M32, t >> 32
    r3 = (r3 + cy) & M32
    return r0 | r1 << 32, r2 | r3 << 32


def _mul_wide(a, b):
    return (a * b) & M64, (a * b) >> 64


def _fold128(lo, hi):
    """gl::fold128 step by step: t = lo − h1 (sub.cc / subc.cc, CF a borrow),
    bm = −borrow, u = t + h0·EPS (mad.lo.cc / madc.hi.cc, CF a carry),
    d = bm + carry, then u + d·EPS as u + (−d) + (d >> 31 arithmetic)·2^32."""
    l0, l1, h0, h1 = lo & M32, lo >> 32, hi & M32, hi >> 32
    t0, cf = (l0 - h1) & M32, int(l0 < h1)
    t1, cf = (l1 - cf) & M32, int(l1 < cf)
    bm = -cf & M32
    prod = h0 * 0xFFFFFFFF
    t = (prod & M32) + t0
    u0, cf = t & M32, t >> 32
    t = (prod >> 32) + t1 + cf
    u1, cf = t & M32, t >> 32
    d = (bm + cf) & M32
    dh = M32 if d >> 31 else 0
    signed = d - 2**32 if d >> 31 else d
    assert 0 <= (u0 | u1 << 32) + signed * EPS <= M64, "the correction wrapped"
    t = u0 + (-d & M32)
    r0, cf = t & M32, t >> 32
    r1 = (u1 + dh + cf) & M32
    return r0 | r1 << 32


def _sqr(a):
    return _fold128(*_sqr_wide(a))


def _mul(a, b):
    return _fold128(*_mul_wide(a, b))


class _Wide3:
    """gl::Wide3: lo, hi (64-bit) and top (32-bit) registers."""

    def __init__(self, offset=False):
        self.lo, self.hi, self.top = (0, 0xFFFFFFFC00000004, 3) if offset else (0, 0, 0)

    def _set(self, v):
        assert 0 <= v < 2**159, "the sum left its three registers"
        self.lo, self.hi, self.top = v & M64, (v >> 64) & M64, v >> 128

    def _int(self):
        return self.lo | self.hi << 64 | self.top << 128

    def add(self, lo, hi):
        self._set(self._int() + (lo | hi << 64))

    def sub(self, lo, hi):
        self._set(self._int() - (lo | hi << 64))

    def value(self):
        assert self.top < 2**31
        v = _sub_wrap(_fold128(self.lo, self.hi), self.top << 32)
        return v - P if v >= P else v


def _add(a, b):
    """gl::add on canonical values."""
    return _sub_wrap(a, P - b)


def _c3_sqr(a):
    s = [_sqr_wide(x) for x in a]
    p01, p02, p12 = _mul_wide(a[0], a[1]), _mul_wide(a[0], a[2]), _mul_wide(a[1], a[2])
    r = [_Wide3() for _ in range(3)]
    for acc, terms in zip(r, ([s[0], p12, p12], [p01, p01, p12, p12, s[2]], [s[1], p02, p02, s[2]])):
        for t in terms:
            acc.add(*t)
    return [acc.value() for acc in r]


def _c3_mul(a, b):
    bs = [_add(b[0], b[1]), _add(b[0], b[2]), _add(b[1], b[2])]
    p00, p11, p22 = (_mul_wide(a[i], b[i]) for i in range(3))
    m01 = _mul_wide(_add(a[0], a[1]), bs[0])
    m02 = _mul_wide(_add(a[0], a[2]), bs[1])
    m12 = _mul_wide(_add(a[1], a[2]), bs[2])
    r = [_Wide3(offset=True) for _ in range(3)]
    for acc, plus, minus in zip(r, ([p00, m12], [m01, m12], [m02, p11]),
                                ([p11, p22], [p00, p11, p11], [p00])):
        for t in plus:
            acc.add(*t)
        for t in minus:
            acc.sub(*t)
    return [acc.value() for acc in r]


def _inv_steps() -> list:
    """(squarings, tail, save) of each step of ``kInvSteps``, read from
    ``csrc/rescue.cu``'s ``inv_step(k, m, tail, save)`` terms."""
    import re
    from pathlib import Path

    src = (Path(rescue.__file__).resolve().parents[1] / "csrc" / "rescue.cu").read_text()
    body = src[src.index("constexpr uint64_t kInvSteps"):]
    body = body[:body.index(";")]
    steps = re.findall(r"inv_step\((\d+),\s*(\d+),\s*(\w+),\s*(\d)\)", body)
    assert [int(k) for k, *_ in steps] == list(range(7))
    return [(int(m), tail, int(save)) for _, m, tail, save in steps]


def _inv_sbox(x, steps):
    """inv_sbox_group's schedule on one lane: x^4 and b = x^7 first, then
    each step's squarings and its product by SELF / KEEP / BVAL."""
    x2 = _sqr(x)
    v = keep = _sqr(x2)
    b = _mul(v, _mul(x2, x))
    for m, src, save in steps:
        tail = {"SELF": v, "KEEP": keep, "BVAL": b}[src]
        for _ in range(m):
            v = _sqr(v)
        v = _mul(v, tail)
        if save:
            keep = v
    return v - P if v >= P else v


def test_model_square_is_the_exact_square():
    for a in MODEL_EDGES + _seeded_u64(21):
        lo, hi = _sqr_wide(a)
        assert lo | hi << 64 == a * a, a


def test_model_fold_reduces_mod_p_below_2_64():
    values = [(lo, hi) for lo in MODEL_EDGES for hi in MODEL_EDGES]
    values += list(zip(_seeded_u64(22), _seeded_u64(23)))
    values += [_sqr_wide(a) for a in MODEL_EDGES + _seeded_u64(24)]
    for lo, hi in values:
        r = _fold128(lo, hi)
        assert 0 <= r <= M64 and r % P == (lo + (hi << 64)) % P, (lo, hi)


def test_model_wide3_offset_is_zero_mod_p_and_covers_three_products():
    w = _Wide3(offset=True)
    assert w._int() == P << 66 and w._int() > 3 * M64 * M64
    assert w.value() == 0
    for _ in range(3):
        w.sub(*_mul_wide(M64, M64))
    assert w.value() == (-3 * M64 * M64) % P


@pytest.mark.parametrize("op", ["square", "product"])
def test_model_cubic_extension_equals_the_plain_twin(op):
    vals = list(EDGE_VALUES) + _seeded_u64(25 if op == "square" else 26, below=P)
    n = len(vals) // 3 * 3
    a = np.array(vals[:n], dtype=np.uint64).reshape(3, -1)
    b = np.roll(a, 1, axis=1) if op == "product" else a
    want = F.to_numpy(rescue._c3_mul(_t(a), _t(b)))
    cols_a, cols_b = _cols(a), _cols(b)
    got = [(_c3_sqr(x) if op == "square" else _c3_mul(x, y)) for x, y in zip(cols_a, cols_b)]
    assert got == _cols(want)


def test_model_lockstep_chain_gives_the_seventh_root():
    steps = _inv_steps()
    assert [m for m, _, _ in steps] == [3, 6, 12, 6, 31, 1, 2]
    assert 2 + sum(m for m, _, _ in steps) == 63  # x^2, x^4, then the steps' squarings
    for x in list(EDGE_VALUES) + _seeded_u64(27, below=P):
        assert _inv_sbox(x, steps) == pow(x, rescue.INV_ALPHA, P), x


def _model_permute(state: list, which: str) -> list:
    """The kernel's permutation on one state with the models above: MDS
    (unchanged, exact here), + ARK, x^7 per lane, x^(1/7) by the lockstep
    schedule, RPX's E round by the Karatsuba models, outputs canonical."""
    from miden_tpu_torch.hash import rescue_constants as RC

    steps = _inv_steps()

    def mds(s):
        return [sum(RC.MDS_ROW0[k] * s[(i + k) % 12] for k in range(12)) % P for i in range(12)]

    def fb(s, r):
        s = [_add(x, c) for x, c in zip(mds(s), RC.ARK1[r])]
        s = [_mul(_sqr(_sqr(x)), _mul(_sqr(x), x)) % P for x in s]
        s = [_add(x, c) for x, c in zip(mds(s), RC.ARK2[r])]
        return [_inv_sbox(x, steps) for x in s]

    def ext(s, r):
        s = [_add(x, c) for x, c in zip(s, RC.ARK1[r])]
        out = []
        for c in range(4):
            a = s[3 * c : 3 * c + 3]
            out += _c3_mul(_c3_sqr(_c3_mul(_c3_sqr(a), a)), a)
        return out

    s = list(state)
    if which == "rpo":
        for r in range(7):
            s = fb(s, r)
        return s
    for r in (0, 2, 4):
        s = ext(fb(s, r), r + 1)
    return [_add(x, c) for x, c in zip(mds(s), RC.ARK1[6])]


@pytest.mark.parametrize("which", ["rpo", "rpx"])
def test_model_permutation_equals_rescue_host_on_edge_states(which):
    states = _cols(rescue.edge_states()) + _cols(_states(28, 4))
    assert [_model_permute(st, which) for st in states] == [HOST[which](st) for st in states]


@pytest.mark.parametrize("which", ["rpo", "rpx"])
def test_edge_state_harness_holds_the_plain_twins_to_rescue_host(which):
    """``rescue.hold_edge_states`` (chip_smoke phase 2 and the card
    tests run it on the kernels) with the plain twins in the kernels' place:
    on the CPU it holds the twins to ``rescue_host`` on the edge states."""
    from types import SimpleNamespace

    sp = SPONGES[which]
    twin = SimpleNamespace(permute_kernel=sp.permute_plain, permute_plain=sp.permute_plain,
                           absorb_rows_kernel=sp.absorb_rows_plain, absorb_rows_plain=sp.absorb_rows_plain,
                           compress_rows_kernel=sp.compress_rows_plain, compress_rows_plain=sp.compress_rows_plain)
    assert rescue.hold_edge_states(twin, HOST[which], "cpu") == {"permute": 0, "absorb_rows": 0, "compress_rows": 0}
