"""miden_tpu_torch.stark.interp ≡ miden_tpu.stark.interp, on the CPU.

The bytecode constraint evaluator: the port's ConstraintProgram must be the
JAX package's instruction for instruction; its plain twin (the CPU side of
kernel Q1) must equal ``miden_tpu``'s ``evaluate_folded_constraints`` on the
same seeded inputs, and the port's eager evaluator on every AIR the
dispatch can route to it; the dispatch must route as ``miden_tpu`` does.
Goldilocks arithmetic is exact, so every comparison is exact equality. Q1
itself is held to the twin on the card (``tests/test_torch_kernels.py``).
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
from miden_tpu_torch.stark import Air, interp, prover
from miden_tpu_torch.stark.domains import LiftedDomain, log_quotient_degree
from miden_tpu_torch.vm.constraints import CoreVmAir
from miden_tpu_torch.vm.constraints.chiplets_air import ChipletsVmAir
from miden_tpu_torch.vm.constraints.poseidon2_air import Poseidon2PermutationAir

N_PUB = 40  # publics of a VM statement's shape: more than any VM AIR reads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU's cores; the twin is
    small-tensor dispatch, as fast on one thread."""
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


class OneConstraintAir(Air):
    """One base-field constraint: its folded accumulator never meets α and
    is lifted base → ext."""

    width = 2

    def eval(self, f):
        f.assert_zero(f.main(0) * f.main(1) - f.main(0, 1))


VM_AIRS = [
    (CoreVmAir, JCoreVmAir),
    (ChipletsVmAir, JChipletsVmAir),
    (Poseidon2PermutationAir, JPoseidon2PermutationAir),
]
PAIRS = VM_AIRS + [(lambda: B.SquareLutAir(4), JSquareLutAir)]


def _pub_count(air) -> int:
    return max(N_PUB, air.num_public_values)


@pytest.mark.parametrize("pair", PAIRS, ids=["core", "chiplets", "poseidon2", "square_lut"])
def test_constraint_program_equals_miden_tpu(pair):
    mine_air, theirs_air = pair[0](), pair[1]()
    n_pub = _pub_count(mine_air)
    args = (n_pub, mine_air.num_randomness, mine_air.num_aux_values)
    mine = interp.ConstraintProgram(mine_air, *args)
    theirs = JI.ConstraintProgram(theirs_air, *args)
    assert np.array_equal(mine.code, theirs.code)
    assert (mine.frame_size, mine.out_slots, mine.n_vec, mine.n_fixed, mine.num_constraints) == (
        theirs.frame_size, theirs.out_slots, theirs.n_vec, theirs.n_fixed, theirs.num_constraints
    )
    assert mine.const_values == theirs.const_values
    assert mine.n_instr == len(theirs.code) or (mine.n_instr == 0 and len(theirs.code) == 1)


def _inputs(air, nd: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.integers(0, gl.P, size=shape, dtype=np.uint64)

    return {
        "main": r(nd, air.width), "aux": r(nd, 2 * air.aux_width), "pp": r(nd, air.preprocessed_width),
        "sels": [r(nd) for _ in range(3)], "periodic": [r(nd) for _ in air.periodic_columns],
        "publics": r(_pub_count(air)), "rand": r(air.num_randomness, 2), "auxv": r(air.num_aux_values, 2),
        "alpha": r(2),
    }


def _port_eval(air, x: dict, d: int) -> np.ndarray:
    t = lambda a: F.to_torch(a, "cpu")  # noqa: E731
    out = interp.evaluate_folded_constraints(
        air, t(x["main"]), t(x["aux"]) if air.aux_width else None, tuple(t(s) for s in x["sels"]),
        t(x["publics"]), t(x["rand"]), t(x["auxv"]), [t(p) for p in x["periodic"]], t(x["alpha"]),
        pp=t(x["pp"]) if air.preprocessed_width else None, next_offset=d,
    )
    return F.to_numpy(out)


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


@pytest.mark.parametrize("log_nd,d", [(9, 8), (10, 4), (11, 2), (12, 8)])
@pytest.mark.parametrize("pair", VM_AIRS, ids=["core", "chiplets", "poseidon2"])
def test_twin_equals_miden_tpu_evaluator(pair, log_nd, d):
    mine_air, theirs_air = pair[0](), pair[1]()
    x = _inputs(mine_air, 1 << log_nd, seed=log_nd * 10 + d)
    assert np.array_equal(_port_eval(mine_air, x, d), _jax_eval(theirs_air, x, d))


def test_twin_on_a_preprocessed_air_equals_miden_tpu():
    x = _inputs(B.SquareLutAir(4), 1 << 9, seed=5)
    assert np.array_equal(_port_eval(B.SquareLutAir(4), x, 2), _jax_eval(JSquareLutAir(), x, 2))


def _session_airs() -> list:
    st = S._session_statement((1, 2, 3, 4), 3, 1, 1, 1)
    return [(type(a).__name__, a, st.publics) for a in st.multi_air.airs]


def _routed_airs() -> list:
    """Every AIR family of the port: the dispatch routes any AIR whose
    quotient domain reaches 2^21 points to the program."""
    shaped, _ = B.miden_shaped_statement(4, device="cpu")
    out = [(name, air, [0] * N_PUB) for name, air in (
        ("CoreVmAir", CoreVmAir()), ("ChipletsVmAir", ChipletsVmAir()),
        ("Poseidon2PermutationAir", Poseidon2PermutationAir()), ("SquareLutAir", B.SquareLutAir(6)),
        ("OneConstraintAir", OneConstraintAir()),
    )]
    out += [(type(a).__name__, a, shaped.publics) for a in shaped.multi_air.airs]
    return out + [x for x in _session_airs() if x[0] != "KeccakAir"]


ROUTED = _routed_airs()


@pytest.mark.parametrize("case", ROUTED, ids=[name for name, _, _ in ROUTED])
def test_program_path_equals_eager_evaluator(case):
    """evaluate_quotient through the recorded program (the plain twin here)
    equals the eager evaluator on the same LDEs, for the VM AIRs, an AIR
    with preprocessed columns, AIRs with periodic columns (Poseidon2, the
    shaped permutation), a single-constraint AIR and the shaped and session
    AIRs."""
    _, air, publics = case
    log_n, log_blowup = 4, 3
    log_d = log_quotient_degree(air.constraint_degree())
    assert log_d <= log_blowup
    dom = LiftedDomain(log_n, log_blowup, 0)
    rng = np.random.default_rng(len(publics) + air.width)

    def rand(*shape):
        return F.to_torch(rng.integers(0, gl.P, size=shape, dtype=np.uint64), "cpu")

    pubs = F.to_torch(np.asarray([int(p) % gl.P for p in publics], dtype=np.uint64), "cpu")
    args = (air, dom, rand(dom.lde_height, air.width), rand(dom.lde_height, 2 * air.aux_width), log_d,
            rand(2), pubs, rand(air.num_randomness, 2), rand(air.num_aux_values, 2),
            rand(dom.lde_height, air.preprocessed_width) if air.preprocessed_width else None)
    assert torch.equal(prover.evaluate_quotient_program(*args), prover.evaluate_quotient_eager(*args))


def test_keccak_program_path_equals_eager_evaluator():
    """The session's widest AIR (1958 columns, 68 periodic): its program
    takes register ids far past 10 bits; Q1's schedule packs its operands
    in 18-bit offsets."""
    (_, air, publics), = [x for x in _session_airs() if x[0] == "KeccakAir"]
    log_d = log_quotient_degree(air.constraint_degree())
    dom = LiftedDomain(5, log_d, 0)  # its periodic columns have period 32
    rng = np.random.default_rng(11)

    def rand(*shape):
        return F.to_torch(rng.integers(0, gl.P, size=shape, dtype=np.uint64), "cpu")

    pubs = F.to_torch(np.asarray([int(p) % gl.P for p in publics], dtype=np.uint64), "cpu")
    args = (air, dom, rand(dom.lde_height, air.width), rand(dom.lde_height, 2 * air.aux_width), log_d,
            rand(2), pubs, rand(air.num_randomness, 2), rand(air.num_aux_values, 2))
    prog = interp.get_program(air, len(publics), air.num_randomness, air.num_aux_values)
    assert 1 << 10 <= prog.n_fixed + prog.frame_size
    assert prog.schedule(interp.Q1_DEFAULT.on_chip).frame_size < 1 << interp.OFFSET_BITS
    assert torch.equal(prover.evaluate_quotient_program(*args), prover.evaluate_quotient_eager(*args))


def test_twin_in_blocks_and_at_spread_points_equals_one_pass(monkeypatch):
    """The twin walks the points in blocks, and evaluates any subset of
    points (the spread-point check on the card): both give the values of
    one pass over the domain, next rows wrapping at the end."""
    air = CoreVmAir()
    x = _inputs(air, 1 << 7, seed=3)
    whole = _port_eval(air, x, 8)
    prog = interp.get_program(air, N_PUB, air.num_randomness, air.num_aux_values)
    monkeypatch.setattr(interp, "PLAIN_BLOCK_ELEMS", 32 * (prog.frame_size + prog.n_vec))
    assert interp.plain_block_points(prog, 1 << 7) == 32
    assert np.array_equal(_port_eval(air, x, 8), whole)

    t = lambda a: F.to_torch(a, "cpu")  # noqa: E731
    consts = F.to_torch(np.asarray(prog.const_values, dtype=np.uint64), "cpu")
    scal = torch.cat([t(x["publics"]), t(x["rand"]).reshape(-1), t(x["auxv"]).reshape(-1), t(x["alpha"]), consts])
    inp = interp.ProgramInputs(
        sources=(t(x["main"]), None, t(x["aux"]), torch.stack([t(s) for s in x["sels"]])),
        scal=scal, nd=1 << 7, next_offset=8,
    )
    points = torch.tensor([0, 5, 100, 119, 120, 127], dtype=torch.int64)
    assert np.array_equal(F.to_numpy(interp.run_program_plain(prog, inp, points)), whole[points.numpy()])


def test_dispatch_routes_as_miden_tpu():
    assert all(prover.uses_program(A(), 4, 3) for A in (CoreVmAir, ChipletsVmAir, Poseidon2PermutationAir))
    shaped, _ = B.miden_shaped_statement(4, device="cpu")
    for air in shaped.multi_air.airs:
        assert not prover.uses_program(air, 1 << 18, 1)  # 2^19 points: eager
        assert prover.uses_program(air, 1 << 20, 1)  # 2^21 points: the program
    assert not prover.uses_program(B.SquareLutAir(18), 1 << 18, 1)


def test_evaluate_quotient_sends_vm_airs_through_the_program(monkeypatch):
    """On CPU tensors the program runs as the plain twin; nothing routes a
    VM AIR to the eager evaluator, and a shaped AIR below 2^21 points stays
    eager."""
    calls = []
    real = interp.run_program

    def spy(prog, inp):
        calls.append(type(prog.air).__name__)
        return real(prog, inp)

    monkeypatch.setattr(interp, "run_program", spy)
    monkeypatch.setattr(prover, "evaluate_quotient_eager", lambda *a: pytest.fail("eager path taken"))
    air = Poseidon2PermutationAir()
    dom = LiftedDomain(4, 3, 0)
    rng = np.random.default_rng(2)

    def rand(*shape):
        return F.to_torch(rng.integers(0, gl.P, size=shape, dtype=np.uint64), "cpu")

    prover.evaluate_quotient(air, dom, rand(128, air.width), rand(128, 2 * air.aux_width), 3, rand(2),
                             rand(N_PUB), rand(air.num_randomness, 2), rand(air.num_aux_values, 2))
    assert calls == ["Poseidon2PermutationAir"]


def test_kernel_wrapper_refuses_cpu_tensors():
    """The twin runs only because the tensors lie on the CPU: the kernel's
    wrapper takes CUDA tensors or raises, and never falls back."""
    air = OneConstraintAir()
    prog = interp.get_program(air, 0, 0, 0)
    nd = 16
    inp = interp.ProgramInputs(
        sources=(torch.zeros((nd, 2), dtype=torch.int64), None, None, torch.zeros((3, nd), dtype=torch.int64)),
        scal=torch.zeros((prog.n_fixed - prog.n_vec,), dtype=torch.int64), nd=nd, next_offset=1,
    )
    before = interp.Q1_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        interp.run_program_kernel(prog, inp)
    assert interp.Q1_KERNEL.launches == before
    assert interp.run_program(prog, inp).shape == (nd, 2)
