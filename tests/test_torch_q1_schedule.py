"""Q1's schedule (``miden_tpu_torch.stark.interp.make_schedule``), on the CPU.

Kernel Q1 runs a program's schedule, not its recorded order: the same
instructions reordered depth first, inputs read again soon loaded into the
frame once, results that only the next instruction reads kept out of the
frame, and the frame split into on-chip and off-chip slots. The checks here
read Q1's own packed tables: the schedule is a permutation of the recorded
instructions in topological order, every operand it reads holds the value
the recorded program reads there, the frame is smaller, and the plain
reader of the tables (``run_schedule_plain``) equals the recorded program's
twin and ``miden_tpu``'s evaluator. Goldilocks arithmetic is exact, so every
comparison is exact equality. The kernel itself is held to the twin on the
card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from miden_tpu.field.goldilocks import Fp2, fp_from_u64, fp_to_u64
from miden_tpu.stark import Air as JAir
from miden_tpu.stark import interp as JI
from miden_tpu.vm.constraints import CoreVmAir as JCoreVmAir
from miden_tpu.vm.constraints.chiplets_air import ChipletsVmAir as JChipletsVmAir
from miden_tpu.vm.constraints.poseidon2_air import Poseidon2PermutationAir as JPoseidon2PermutationAir
from miden_tpu_torch import bench_airs as B
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.precompile import session as S
from miden_tpu_torch.stark import interp
from miden_tpu_torch.vm.constraints import CoreVmAir
from miden_tpu_torch.vm.constraints.chiplets_air import ChipletsVmAir
from miden_tpu_torch.vm.constraints.poseidon2_air import Poseidon2PermutationAir

N_PUB = 40
#: on-chip budgets checked: Q1's default (most of a VM frame off chip), one
#: that keeps most accesses on chip, and none at all
ON_CHIP = [interp.Q1_DEFAULT.on_chip, 48, 0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JSquareLutAir(JAir):
    """``bench_airs.SquareLutAir`` against miden_tpu's folder."""

    width = 1
    preprocessed_width = 1
    num_public_values = 1

    def eval(self, f):
        f.assert_zero(f.main(0) - f.preprocessed(0) - f.public(0))
        f.assert_transition(f.main(0, 1) - f.preprocessed(0, 1) - f.public(0))


def _keccak():
    st = S._session_statement((1, 2, 3, 4), 3, 1, 1, 1)
    (air,) = [a for a in st.multi_air.airs if type(a).__name__ == "KeccakAir"]
    return air


#: name -> (the port's AIR, miden_tpu's AIR, or None where no evaluator is
#: run on it here)
AIRS = {
    "core": (CoreVmAir, JCoreVmAir),
    "chiplets": (ChipletsVmAir, JChipletsVmAir),
    "poseidon2": (Poseidon2PermutationAir, JPoseidon2PermutationAir),
    "square_lut": (lambda: B.SquareLutAir(4), JSquareLutAir),
    "keccak": (_keccak, None),
}


def _program(name: str):
    air = AIRS[name][0]()
    return air, interp.get_program(air, max(N_PUB, air.num_public_values), air.num_randomness,
                                   air.num_aux_values)


def _expect(prog, r: int) -> tuple:
    """What the recorded program reads for an SSA operand of ``interp._ssa``."""
    if r >= 0:
        return ("value", r)
    reg = ~r
    return ("input", reg) if reg < prog.n_vec else ("scalar", reg - prog.n_vec)


@pytest.mark.parametrize("on_chip", ON_CHIP)
@pytest.mark.parametrize("name", list(AIRS))
def test_schedule_is_a_topological_permutation_of_the_program(name, on_chip):
    """Replays the packed tables symbolically: each slot holds the name of
    the value last stored there, and every operand of every scheduled
    instruction (and each output) must read the value the recorded program
    reads — so each is defined before it is read and no slot is overwritten
    while live. The recorded instructions appear once each, in the recorded
    instruction's op; each LOAD adds the constant 0 to a vector input; each
    word's path bit is the one its fields call for."""
    _, prog = _program(name)
    sched = prog.schedule(on_chip)
    ops, outs = interp._ssa(prog)
    desc = {s | nx << 2 | col << 3: reg for reg, (s, col, nx) in enumerate(prog._vec_sources)}
    frames = ({}, {})
    prev = None

    def read(operand):
        if operand is None:
            return prev
        kind, off = operand
        if kind in (interp.KIND_ON, interp.KIND_OFF):
            assert off < (sched.n_on if kind == interp.KIND_ON else sched.n_off)
            return frames[kind][off]  # KeyError: read before any store
        if kind == interp.KIND_SCALAR:
            return ("scalar", off)
        return ("input", desc[off])

    recorded = sched.order[sched.order >= 0]
    assert np.array_equal(np.sort(recorded), np.arange(prog.n_instr))
    assert len(sched.order) == sched.n_instr <= sched.n_run and sched.n_run % interp.BATCH == 0
    for t, word in enumerate(sched.code[: sched.n_instr].view(np.uint64).tolist()):
        op, (dkind, doff), a, b = interp.decode(word)
        assert bool(word & 1 << 10) == interp.is_rare((dkind, doff), a, b)  # the kernel's path
        src = int(sched.order[t])
        if src < 0:
            zero = prog.n_inputs + prog.const_values.index(0) - prog.n_vec
            assert op == interp.OP_ADD and ~src < prog.n_vec and read(a) == ("input", ~src)
            assert read(b) == ("scalar", zero)
            value = ("input", ~src)
        else:
            rop, ra, rb = ops[src]
            assert op == rop and read(a) == _expect(prog, ra) and read(b) == _expect(prog, rb)
            value = ("value", src)
        if dkind != interp.DST_NONE:
            assert doff < (sched.n_on if dkind == interp.KIND_ON else sched.n_off)
            frames[dkind][doff] = value
        prev = value
    for packed, want in zip(sched.outs, outs):
        assert read((packed & 3, packed >> 2)) == _expect(prog, want)


@pytest.mark.parametrize("name", list(AIRS))
def test_scheduled_frame_is_smaller(name):
    """Every slot is on chip or off chip (two numberings, never both), at
    most the budget on chip; the scheduled frame is no larger than the
    recorded one, and at most 160 slots for the VM core at Q1's default."""
    _, prog = _program(name)
    for on_chip in ON_CHIP:
        sched = prog.schedule(on_chip)
        assert sched.n_on <= on_chip and sched.frame_size == sched.n_on + sched.n_off
        assert sched.frame_size <= prog.frame_size
    if name == "core":
        assert prog.schedule(interp.Q1_DEFAULT.on_chip).frame_size <= 160


def _inputs(air, nd: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.integers(0, gl.P, size=shape, dtype=np.uint64)

    return {
        "main": r(nd, air.width), "aux": r(nd, 2 * air.aux_width), "pp": r(nd, air.preprocessed_width),
        "sels": [r(nd) for _ in range(3)], "periodic": [r(nd) for _ in air.periodic_columns],
        "publics": r(max(N_PUB, air.num_public_values)), "rand": r(air.num_randomness, 2),
        "auxv": r(air.num_aux_values, 2), "alpha": r(2),
    }


def _jax_eval(air, x: dict, d: int) -> np.ndarray:
    def ext(a):
        return Fp2(fp_from_u64(a[..., 0]), fp_from_u64(a[..., 1]))

    out = JI.evaluate_folded_constraints(
        air, fp_from_u64(x["main"]), fp_from_u64(x["aux"]) if air.aux_width else None,
        tuple(fp_from_u64(s) for s in x["sels"]), fp_from_u64(x["publics"]), ext(x["rand"]),
        ext(x["auxv"]), [fp_from_u64(p) for p in x["periodic"]], ext(x["alpha"]),
        pp=fp_from_u64(x["pp"]) if air.preprocessed_width else None, next_offset=d,
    )
    return np.stack([fp_to_u64(out.c0), fp_to_u64(out.c1)], axis=1)


@pytest.mark.parametrize("name", [n for n in AIRS if AIRS[n][1] is not None])
def test_schedule_reader_equals_twin_and_miden_tpu(name):
    """The plain reader of Q1's packed tables, at every budget of ON_CHIP,
    equals the recorded program's twin and miden_tpu's evaluator on the
    same seeded inputs, with next rows D = 8 ahead wrapping at the end.
    (KeccakAir's 92,287 instructions take the torch twin and the reader
    over half a minute here: its schedule is held to the recorded program
    by the replay above, and Q1 to the twin on the card.)"""
    air, prog = _program(name)
    nd, d = 64, 8
    x = _inputs(air, nd, seed=len(name))
    t = lambda a: F.to_torch(a, "cpu")  # noqa: E731
    _, inp = interp.program_inputs(
        air, t(x["main"]), t(x["aux"]) if air.aux_width else None, tuple(t(s) for s in x["sels"]),
        t(x["publics"]), t(x["rand"]), t(x["auxv"]), [t(p) for p in x["periodic"]], t(x["alpha"]),
        pp=t(x["pp"]) if air.preprocessed_width else None, next_offset=d,
    )
    want = interp.run_program_plain(prog, inp)
    assert np.array_equal(F.to_numpy(want), _jax_eval(AIRS[name][1](), x, d))
    for on_chip in ON_CHIP:
        assert torch.equal(interp.run_schedule_plain(prog, prog.schedule(on_chip), inp), want)
