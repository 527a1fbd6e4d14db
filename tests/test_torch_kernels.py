"""The port's CUDA kernels against their plain torch twins, on the card.

K1 (``ntt_col_transform``), K2 (``ntt_transpose_twiddle`` inside the
four-step decomposition), K3's three entries (``poseidon2_permute``,
``poseidon2_absorb_rows``, ``poseidon2_compress_rows``), those of R1
(RPO-256) and R2 (RPX-256), and Q1 (``constraints_eval``, the recorded
constraint program) are compared with the plain versions on the same CUDA
inputs, and ``MerkleTree`` folds its
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
        pytest.skip("needs an NVIDIA GPU (kernels K1-K3, R1, R2 and Q1 have no CPU mode)")


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
def test_rescue_kernels_match_plain_and_host_on_edge_states(which):
    """0, 1, p - 1, p - 2, 2^32 - 1, 2^32, 2^48, 2^63 - 1, 2^63 in all-equal
    and mixed lanes reach the carry paths of the squares and the lazy sums
    that uniform random states rarely reach."""
    sponge, host, _ = RESCUE[which]
    kernels = (sponge.PERMUTE_KERNEL, sponge.ABSORB_KERNEL, sponge.COMPRESS_KERNEL)
    counts = [k.launches for k in kernels]
    errs = rescue.hold_edge_states(sponge, host, "cuda")
    assert [k.launches - c for k, c in zip(kernels, counts)] == [1, 1, 1]
    assert errs == {"permute": 0, "absorb_rows": 0, "compress_rows": 0}


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


def _q1_airs():
    from miden_tpu_torch import bench_airs
    from miden_tpu_torch.precompile import session
    from miden_tpu_torch.vm.constraints import CoreVmAir
    from miden_tpu_torch.vm.constraints.chiplets_air import ChipletsVmAir
    from miden_tpu_torch.vm.constraints.poseidon2_air import Poseidon2PermutationAir

    keccak = [a for a in session._session_statement((1, 2, 3, 4), 3, 1, 1, 1).multi_air.airs
              if type(a).__name__ == "KeccakAir"]
    return {"core": CoreVmAir(), "chiplets": ChipletsVmAir(), "poseidon2": Poseidon2PermutationAir(),
            "square_lut": bench_airs.SquareLutAir(6), "keccak": keccak[0]}


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("which", ["core", "chiplets", "poseidon2", "square_lut", "keccak"])
def test_constraint_kernel_matches_plain(which, stride):
    """Q1 against its plain twin on the same CUDA inputs: a VM AIR, an AIR
    with preprocessed columns and the session's widest (periodic columns,
    register ids past 10 bits), reading row-strided LDE views whose next
    rows wrap around the domain's end."""
    from miden_tpu_torch.stark import interp

    air = _q1_airs()[which]
    nd, d = 1 << 10, 8
    rng = np.random.default_rng(len(which) * 10 + stride)

    def view(k):
        return _rand(rng, (nd * stride, k))[::stride] if k else None

    inputs = (
        air, view(air.width), view(2 * air.aux_width), tuple(_rand(rng, (nd,)) for _ in range(3)),
        _rand(rng, (max(40, air.num_public_values),)), _rand(rng, (air.num_randomness, 2)),
        _rand(rng, (air.num_aux_values, 2)), [_rand(rng, (nd,)) for _ in air.periodic_columns],
        _rand(rng, (2,)),
    )
    pp = view(air.preprocessed_width)
    before = interp.Q1_KERNEL.launches
    got = interp.evaluate_folded_constraints(*inputs, pp=pp, next_offset=d)
    torch.cuda.synchronize()
    assert interp.Q1_KERNEL.launches == before + 1
    real = interp.run_program
    try:
        interp.run_program = interp.run_program_plain
        want = interp.evaluate_folded_constraints(*inputs, pp=pp, next_offset=d)
    finally:
        interp.run_program = real
    assert interp.Q1_KERNEL.launches == before + 1
    assert _equal(got, want)


@pytest.mark.parametrize("which", ["core", "poseidon2", "square_lut"])
def test_constraint_kernel_with_a_halo_matches_plain(which):
    """Q1 on a block of a sharded quotient coset: the last D points read
    their next rows from a halo (strided views of other tensors), as the
    plain twin does; equal to the twin over the block and to the whole
    coset's run over the same rows."""
    from miden_tpu_torch.stark import interp

    air = _q1_airs()[which]
    nd, d, stride = 1 << 10, 8, 2
    rng = np.random.default_rng(len(which) + 70)

    def whole(k):
        return _rand(rng, (2 * nd * stride, k))[::stride] if k else None

    srcs = [whole(air.width), whole(air.preprocessed_width), whole(2 * air.aux_width)]
    sels = tuple(_rand(rng, (2 * nd,)) for _ in range(3))
    periodic = [_rand(rng, (2 * nd,)) for _ in air.periodic_columns]
    scal = (_rand(rng, (max(40, air.num_public_values),)), _rand(rng, (air.num_randomness, 2)),
            _rand(rng, (air.num_aux_values, 2)))
    alpha = _rand(rng, (2,))

    def inputs(rows, halo=None):
        cut = [None if x is None else x[rows] for x in srcs]
        return interp.program_inputs(
            air, cut[0], cut[2], tuple(x[rows] for x in sels), *scal, [x[rows] for x in periodic], alpha,
            pp=cut[1], next_offset=d, halo=halo)

    first = slice(0, nd)
    halo = tuple(None if x is None else x[nd : nd + d] for x in srcs)
    prog, inp = inputs(first, halo)
    before = interp.Q1_KERNEL.launches
    got = interp.run_program_kernel(prog, inp)
    torch.cuda.synchronize()
    assert interp.Q1_KERNEL.launches == before + 1
    assert _equal(got, interp.run_program_plain(prog, inp))
    prog_w, inp_w = inputs(slice(0, 2 * nd))
    assert _equal(got, interp.run_program_kernel(prog_w, inp_w)[:nd])


def _q1_case(which: str, nd: int, d: int, seed: int):
    """(program, ProgramInputs) of an AIR of :func:`_q1_airs` on random card
    inputs, its LDE sources row-strided views (stride 2)."""
    from miden_tpu_torch.stark import interp

    air = _q1_airs()[which]
    rng = np.random.default_rng(seed)

    def view(k):
        return _rand(rng, (nd * 2, k))[::2] if k else None

    return interp.program_inputs(
        air, view(air.width), view(2 * air.aux_width), tuple(_rand(rng, (nd,)) for _ in range(3)),
        _rand(rng, (max(40, air.num_public_values),)), _rand(rng, (air.num_randomness, 2)),
        _rand(rng, (air.num_aux_values, 2)), [_rand(rng, (nd,)) for _ in air.periodic_columns],
        _rand(rng, (2,)), view(air.preprocessed_width), d,
    )


@pytest.mark.parametrize("points,block,on_chip", [
    (2, 128, 4),  # the core's 160-slot frame far past the on-chip budget: 156 slots off chip
    (1, 64, 0),  # no slot on chip
    (4, 64, 48),
    (2, 32, 160),  # every slot on chip
])
@pytest.mark.parametrize("which", ["core", "keccak"])
def test_constraint_kernel_settings_match_plain(which, points, block, on_chip):
    """Q1 under other launch settings: k points a thread, the block, and an
    on-chip budget that leaves most of the frame, or all of it, off chip."""
    from miden_tpu_torch.stark import interp

    prog, inp = _q1_case(which, 1 << 11, 8, seed=points * 1000 + on_chip)
    setting = interp.Q1Setting(points=points, block=block, on_chip=on_chip)
    plan = interp.q1_plan(prog, inp.nd, setting)
    assert plan.sched.n_on <= on_chip and plan.sched.frame_size >= plan.sched.n_on
    got = interp.run_program_kernel(prog, inp, setting)
    assert _equal(got, interp.run_program_plain(prog, inp))


@pytest.mark.parametrize("nd", [1, 4, 64])
def test_constraint_kernel_domain_smaller_than_a_tile(nd):
    """nd below one tile (block x k points): one block, its threads past nd
    write nothing, next rows wrap within the domain."""
    from miden_tpu_torch.stark import interp

    prog, inp = _q1_case("chiplets", nd, max(1, nd // 4), seed=nd)
    plan = interp.q1_plan(prog, nd)
    assert plan.blocks == 1 and plan.tile > nd
    assert _equal(interp.run_program_kernel(prog, inp), interp.run_program_plain(prog, inp))


def test_constraint_kernel_refuses_what_it_does_not_take():
    from miden_tpu_torch.stark import interp

    air = _q1_airs()["square_lut"]
    prog = interp.get_program(air, 1, 0, 0)
    nd = 64
    ok = interp.ProgramInputs(
        sources=(torch.zeros((nd, 1), dtype=torch.int64, device="cuda"),
                 torch.zeros((nd, 1), dtype=torch.int64, device="cuda"), None,
                 torch.zeros((3, nd), dtype=torch.int64, device="cuda")),
        scal=torch.zeros((prog.n_fixed - prog.n_vec,), dtype=torch.int64, device="cuda"), nd=nd, next_offset=1,
    )
    assert interp.run_program_kernel(prog, ok).shape == (nd, 2)
    with pytest.raises(ValueError):  # not a power of two
        interp.run_program_kernel(prog, interp.ProgramInputs(ok.sources, ok.scal, 48, 1))
    with pytest.raises(ValueError):  # a source of another height
        interp.run_program_kernel(prog, interp.ProgramInputs(
            (ok.sources[0][:32], *ok.sources[1:]), ok.scal, nd, 1))
    with pytest.raises(ValueError):  # a CPU source
        interp.run_program_kernel(prog, interp.ProgramInputs(
            (ok.sources[0].cpu(), *ok.sources[1:]), ok.scal, nd, 1))
