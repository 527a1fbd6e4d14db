"""The port's LogUp aux builder ≡ miden_tpu's exact per-row builder.

``miden_tpu_torch``'s VM AIRs build their aux traces with
``aux_numeric.build_device_aux`` (torch tensors, every row at once, one
batch inverse of all denominators, a prefix scan for the accumulator).
Here it is held against ``miden_tpu``'s ``build_numeric_aux`` (exact Python
ints, row by row) on real execution traces of all three VM AIRs with fixed
randomness: the accumulator, every fraction column and the committed final
value, with max |diff| 0.
"""

import numpy as np
import pytest

from miden_tpu.vm import assemble as j_assemble
from miden_tpu.vm.constraints.aux_numeric import build_numeric_aux as j_build_numeric_aux
from miden_tpu.vm.constraints.chiplets_air import ChipletsVmAir as JChiplets
from miden_tpu.vm.constraints.chiplets_air import chiplet_bus_columns as j_chiplet_bus_columns
from miden_tpu.vm.constraints.core import CoreVmAir as JCore
from miden_tpu.vm.trace import execute_and_trace as j_execute_and_trace
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.vm.constraints import CoreVmAir
from miden_tpu_torch.vm.constraints.aux_numeric import build_numeric_aux
from miden_tpu_torch.vm.constraints.chiplets_air import ChipletsVmAir, chiplet_bus_columns
from miden_tpu_torch.vm.constraints.poseidon2_air import Poseidon2PermutationAir

RAND = [(0x1234_5678_9ABC_DEF0, 0x0FED_CBA9_8765_4321), (12345, 67890)]
PROGRAMS = {
    "u32_if": (
        "begin push.2 push.3 u32wrapping_add push.5 mul "
        "push.1 if.true push.7 add else push.8 add end swap drop end"
    ),
    "fib": "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end",
}
AIRS = {"core": (CoreVmAir, "matrix"), "chiplets": (ChipletsVmAir, "chiplets"),
        "poseidon": (Poseidon2PermutationAir, "poseidon")}
_TRACES: dict = {}


def _trace(program):
    if program not in _TRACES:
        _TRACES[program] = j_execute_and_trace(j_assemble(PROGRAMS[program]))[1]
    return _TRACES[program]


def _publics(trace):
    return (
        list(trace.stack_inputs) + list(trace.stack_outputs)
        + list(trace.program_hash) + [0, 0, 0, 0]
    )


def _jax_air(name):
    from miden_tpu.vm.constraints.poseidon2_air import Poseidon2PermutationAir as JPoseidon

    return {"core": JCore, "chiplets": JChiplets, "poseidon": JPoseidon}[name]()


@pytest.mark.parametrize("program", sorted(PROGRAMS))
@pytest.mark.parametrize("air_name", sorted(AIRS))
def test_torch_aux_builder_equals_miden_tpu_numeric(program, air_name):
    trace = _trace(program)
    air_cls, field = AIRS[air_name]
    main = np.asarray(getattr(trace, field), dtype=np.uint64)
    publics = _publics(trace)
    # miden_tpu on the CPU routes host randomness to its exact numeric builder
    want, want_vals = _jax_air(air_name).build_aux_trace(main, publics, [], RAND)
    rand = [F.ext_const(r, device="cpu") for r in RAND]
    got, got_vals = air_cls().build_aux_trace(F.to_torch(main, "cpu"), publics, [], rand)
    n, cols, _ = want.shape
    assert tuple(got.shape) == (n, 2 * cols)
    diff = np.argwhere(F.to_numpy(got).reshape(n, cols, 2) != want)
    assert diff.size == 0, f"{air_name}: aux differs first at {diff[:5]}"
    assert (F.to_numpy(got)[n - 1, 2:] == 0).all()  # no transition on the last row
    got_pairs = [tuple(int(x) for x in v) for v in F.to_numpy(got_vals)]
    assert got_pairs == [tuple(int(x) for x in v) for v in want_vals]
    assert len(got_pairs) == air_cls.num_aux_values


def test_core_accumulator_starts_at_the_seed_inverse():
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.vm.constraints.buses import core_bus_columns, seed_denominator
    from miden_tpu_torch.vm.constraints.op_flags import OpFlags

    trace = _trace("fib")
    main = np.asarray(trace.matrix, dtype=np.uint64)
    publics = _publics(trace)
    aux, _ = build_numeric_aux(
        CoreVmAir(), main, publics, RAND, lambda f: core_bus_columns(f, OpFlags(f))[0],
        seed_fn=seed_denominator,
    )
    rand = [F.ext_const(r, device="cpu") for r in RAND]
    got, _ = CoreVmAir().build_aux_trace(F.to_torch(main, "cpu"), publics, [], rand)
    row0 = tuple(int(x) for x in F.to_numpy(got)[0, :2])
    assert row0 == tuple(int(x) for x in aux[0, 0])
    assert row0 != (0, 0)
    # the seed is the inverse of the row-0 seed denominator
    assert gl.ext_mul(row0, _row0_seed_denominator(main, publics)) == (1, 0)


def _row0_seed_denominator(main, publics):
    from miden_tpu_torch.stark.air import Expr, Folder, ScalarBackend
    from miden_tpu_torch.vm.constraints.buses import seed_denominator

    be = ScalarBackend()
    f = Folder(
        be,
        main_fn=lambda c, o=0: Expr(be, "base", int(main[o, c])),
        publics=[Expr(be, "base", int(v)) for v in publics],
        randomness=[Expr(be, "ext", r) for r in RAND],
        selectors=(Expr(be, "base", 0), Expr(be, "base", 0), Expr(be, "base", 1)),
    )
    return seed_denominator(f).val


def test_port_numeric_builder_equals_miden_tpu():
    trace = _trace("u32_if")
    main = np.asarray(trace.chiplets, dtype=np.uint64)
    publics = _publics(trace)
    want, want_vals = j_build_numeric_aux(JChiplets(), main, publics, RAND, j_chiplet_bus_columns)
    got, got_vals = build_numeric_aux(ChipletsVmAir(), main, publics, RAND, chiplet_bus_columns)
    assert (got == want).all() and got_vals == want_vals

