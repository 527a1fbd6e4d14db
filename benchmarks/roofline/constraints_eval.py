"""Q1 (`csrc/constraints.cu`) `constraints_eval`: an AIR's recorded
constraint program over every point of a quotient coset.

Its work depends on the program, which the port records from the AIR at run
time; it is frozen here per AIR, as recorded for the VM statement (40
publics) by the port's ``stark/interp.py`` at the commit that added this
file: ``n_mul`` MUL instructions, ``cols`` per-point input columns (main,
preprocessed, two per aux column, three selectors and the periodic
columns), ``scal`` scalar inputs. A later change to the program does not
move these counts; an AIR without an entry has no bound.
"""

from __future__ import annotations

from benchmarks.harness.work import INT32_MULS_PER_MUL

PROGRAMS = {
    "CoreVmAir": {"n_mul": 5219, "cols": 66, "scal": 83},
    "ChipletsVmAir": {"n_mul": 1887, "cols": 46, "scal": 70},
    "Poseidon2PermutationAir": {"n_mul": 1033, "cols": 39, "scal": 66},
}


def work_of(key: tuple):
    """(bytes, 32-bit multiplies) of one launch at the shape ``key`` =
    (AIR, points[, "halo"]), or None for an AIR without an entry: every
    per-point column read once (a next row is another point's current row),
    the scalars read once, the (nd, 2) output written once; every MUL a
    general Goldilocks product at every point."""
    air, nd = key[0], key[1]
    prog = PROGRAMS.get(air)
    if prog is None:
        return None
    return 8 * (nd * prog["cols"] + prog["scal"] + 2 * nd), prog["n_mul"] * INT32_MULS_PER_MUL * nd
