"""D1 (``csrc/deep.cu``), the DEEP step of the PCS opening, against its plain
twins, and the dispatch that keeps CPU tensors on the twins.

On the card (``cuda`` marker; each such test skips without one) D1's two
entries must equal the plain torch exactly: ``compute_deep_claims`` /
``deep_compose`` against ``compute_deep_claims_plain`` /
``deep_compose_plain`` on random committed matrices at lifted heights and at
small ones, a rank's block at a row offset, and the two inside a CUDA graph
replayed with new points. On the CPU: no CPU tensor reaches D1, the OOD
launch plan covers every column and row, and the twins' offsets agree with
the whole. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_deep_kernel.py
"""

import numpy as np
import pytest
import torch

from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.merkle.lmcs import LmcsTree
from miden_tpu_torch.stark import pcs
from miden_tpu_torch.stark.domains import LiftedDomain
from miden_tpu_torch.utils import cuda

#: log heights of each tree's matrices: the vm-fib-18 LDEs, and small ones
HEIGHTS = {"lifted": (21, 19, 16), "small": (6, 4, 1)}
WIDTHS = [0, 1, 7, 51, 130]


@pytest.fixture
def card():
    """Uniform canonical field elements made on the card from a seeded
    generator (values >= p as u64 wrap to v - p)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (D1 has no CPU mode)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)

    def rand(shape):
        halves = torch.randint(0, 1 << 32, (2, *shape), generator=gen, dtype=torch.int64, device="cuda")
        v = (halves[0] << 32) | halves[1]
        return torch.where((v < 0) & (v > -(1 << 32)), v + ((1 << 32) - 1), v)

    return rand


def _cpu_rand(seed):
    rng = np.random.default_rng(seed)
    return lambda shape: F.to_torch(rng.integers(0, gl.P, size=shape, dtype=np.uint64), "cpu")


def _trees(rand, log_heights, w):
    """Three trees of the opening's shape: (H, w), (H/4, 16), (H/32, 24); a
    second tree (H, 12), (H/4, 4), (H/32, 16); a third (H, 16). Nothing is
    hashed: D1 reads the matrices alone."""
    a, b, c = (1 << k for k in log_heights)
    shapes = [[(a, w), (b, 16), (c, 24)], [(a, 12), (b, 4), (c, 16)], [(a, 16)]]
    return [LmcsTree(matrices=[rand(s) for s in tree], heights=[s[0] for s in tree],
                     widths=[s[1] for s in tree], layers=[]) for tree in shapes]


def _equal(a, b):
    return torch.equal(a.cpu(), b.cpu())


def _claims_equal(got, want):
    assert got.aligned_widths == want.aligned_widths
    for g_point, w_point in zip(got.evals, want.evals):
        for g, w in zip(g_point, w_point):
            assert _equal(g, w)


def _nonzero(trees):
    return sum(1 for t in trees for m in t.matrices if m.shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("heights", sorted(HEIGHTS))
def test_deep_claims_and_quotient_match_plain(card, heights, w):
    log_h = HEIGHTS[heights]
    trees = _trees(card, log_h, w)
    zs = [card((2,)), card((2,))]
    alpha, beta = card((2,)), card((2,))
    ood, rows = pcs.OOD_KERNEL.launches, pcs.ROWS_KERNEL.launches
    got = pcs.compute_deep_claims(trees, zs)
    torch.cuda.synchronize()
    assert pcs.OOD_KERNEL.launches == ood + _nonzero(trees)
    want = pcs.compute_deep_claims_plain(trees, zs)
    _claims_equal(got, want)
    dom = LiftedDomain(log_h[0] - 3, 3)
    q = pcs.deep_compose(dom, trees, want, zs, alpha, beta)
    torch.cuda.synchronize()
    assert pcs.ROWS_KERNEL.launches == rows + 1
    assert _equal(q, pcs.deep_compose_plain(dom, trees, want, zs, alpha, beta))


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [1, 3])
def test_a_ranks_block_at_its_offset_matches_plain(card, rank):
    """A rank of four: its block of a (2^19, 51) matrix lifted by 4, and its
    block of the 2^21-point DEEP quotient over its own block of a 2^21-row
    matrix (a RowShard's local rows), a whole 2^20-row matrix and a whole
    2^16-row one."""
    size = 4
    zs = [card((2,)), card((2,))]
    alpha, beta = card((2,)), card((2,))
    m = card((1 << 19, 51))
    rows = m.shape[0] // size
    block = m[rank * rows : (rank + 1) * rows]
    got = pcs.ood_sums(block, 19, rank * rows, 2, zs)
    assert _equal(got, pcs.ood_sums_plain(block, 19, rank * rows, 2, zs))

    rows = (1 << 21) // size
    start = rank * rows
    mats = [(card((rows, 51)), 0, 56), (card((1 << 20, 7)), start, 8), (card((1 << 16, 24)), start, 24)]
    claims = card((2, 88, 2))
    pts = pcs.coset_points(21, gl.canonical_lde_shift(21), "cuda", start, rows)
    got = pcs.deep_rows(mats, rows, pts, zs, claims, alpha, beta)
    assert _equal(got, pcs.deep_rows_plain(mats, rows, pts, zs, claims, alpha, beta))


@pytest.mark.cuda
def test_d1_in_a_cuda_graph_takes_new_points_on_replay(card):
    trees = _trees(card, (12, 10, 7), 51)
    dom = LiftedDomain(9, 3)
    z, alpha, beta = card((2,)), card((2,)), card((2,))
    omega = gl.two_adic_generator(dom.log_trace_height)

    def step(z, alpha, beta):
        zs = [z, F.ext_mul_base(z, F.const(omega, device="cuda"))]
        claims = pcs.compute_deep_claims(trees, zs)
        return claims, pcs.deep_compose(dom, trees, claims, zs, alpha, beta)

    step(z, alpha, beta)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(z, alpha, beta)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with cuda.recording_launches() as log, torch.cuda.graph(graph):
        claims, q = step(z, alpha, beta)
    _, per_kernel = cuda.graph_kernel_nodes(graph)
    assert per_kernel == log.per_kernel() == {pcs.OOD_KERNEL: _nonzero(trees), pcs.ROWS_KERNEL: 1}
    graph.instantiate()
    for _ in range(2):
        for t in (z, alpha, beta):
            t.copy_(card((2,)))
        graph.replay()
        torch.cuda.synchronize()
        zs = [z.clone(), F.ext_mul_base(z, F.const(omega, device="cuda"))]
        want = pcs.compute_deep_claims_plain(trees, zs)
        _claims_equal(claims, want)
        assert _equal(q, pcs.deep_compose_plain(dom, trees, want, zs, alpha, beta))


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_reach_d1():
    rand = _cpu_rand(1)
    trees = _trees(rand, (6, 4, 1), 7)
    zs = [rand((2,)), rand((2,))]
    alpha, beta = rand((2,)), rand((2,))
    ood, rows = pcs.OOD_KERNEL.launches, pcs.ROWS_KERNEL.launches
    claims = pcs.compute_deep_claims(trees, zs)
    dom = LiftedDomain(3, 3)
    q = pcs.deep_compose(dom, trees, claims, zs, alpha, beta)
    assert (pcs.OOD_KERNEL.launches, pcs.ROWS_KERNEL.launches) == (ood, rows)
    _claims_equal(claims, pcs.compute_deep_claims_plain(trees, zs))
    assert _equal(q, pcs.deep_compose_plain(dom, trees, claims, zs, alpha, beta))


@pytest.mark.parametrize("entry", ["ood_sums", "deep_rows"])
def test_d1_entries_refuse_cpu_tensors(entry):
    rand = _cpu_rand(2)
    zs = [rand((2,)), rand((2,))]
    m = rand((16, 3))
    with pytest.raises(ValueError, match="CUDA"):
        if entry == "ood_sums":
            pcs.ood_sums(m, 4, 0, 0, zs)
        else:
            pts = pcs.coset_points(4, gl.canonical_lde_shift(4), "cpu")
            pcs.deep_rows([(m, 0, 8)], 16, pts, zs, rand((2, 8, 2)), rand((2,)), rand((2,)))


@pytest.mark.parametrize("rows", [1, 8, 1 << 10, 1 << 16, 1 << 19, 1 << 21])
@pytest.mark.parametrize("w", [1, 4, 7, 51, 130, 256, 257, 5800])
def test_ood_plan_covers_every_column_and_row(rows, w):
    tc, rl, tiles, per, grid = pcs.ood_plan(rows, w, 132)
    assert 1 <= tc * rl <= pcs.OOD_THREADS and tiles * tc >= w > (tiles - 1) * tc
    assert per % pcs.OOD_CHUNK == 0 and grid * per >= rows > (grid - 1) * per


def test_plain_ood_sums_of_the_blocks_add_up_to_the_whole():
    """A rank's claims (ood_sums_plain of its rows at their offset) summed
    over the ranks are the whole matrix's: what sum_partials relies on."""
    rand = _cpu_rand(3)
    m, zs = rand((64, 5)), [rand((2,)), rand((2,))]
    parts = [pcs.ood_sums_plain(m[s : s + 16], 6, s, 1, zs) for s in range(0, 64, 16)]
    total = parts[0]
    for p in parts[1:]:
        total = F.add(total, p)
    assert _equal(total, pcs.ood_sums_plain(m, 6, 0, 1, zs))


def test_plain_deep_rows_of_a_block_are_the_wholes_rows():
    """The DEEP quotient over a block of rows [start, start + rows), its
    matrices lifted from their offsets, is that slice of the whole one."""
    rand = _cpu_rand(4)
    big, size, rank = 64, 4, 2
    rows, start = big // size, rank * big // size
    full, long, short = rand((big, 5)), rand((32, 3)), rand((4, 2))
    zs, claims = [rand((2,)), rand((2,))], rand((2, 24, 2))
    alpha, beta = rand((2,)), rand((2,))
    whole = pcs.deep_rows_plain([(full, 0, 8), (long, 0, 8), (short, 0, 8)], big,
                                pcs.coset_points(6, 7, "cpu"), zs, claims, alpha, beta)
    block = pcs.deep_rows_plain([(full[start : start + rows], 0, 8), (long, start, 8), (short, start, 8)], rows,
                                pcs.coset_points(6, 7, "cpu", start, rows), zs, claims, alpha, beta)
    assert _equal(block, whole[start : start + rows])
