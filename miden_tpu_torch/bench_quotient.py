"""The quotient on the card: Q1 against the eager evaluator, per VM AIR.

    python3 -m miden_tpu_torch.bench_quotient [--reps 5] [--parent DIR] [--sweep]

Proves bench.py's real-program row (the fib program with repeat.84000: core
2^18 rows, a 2^21-point quotient domain; vm-fib-18) at MIDEN_PARAMS once,
keeping each VM AIR's quotient inputs (its LDEs and challenges). For each
AIR it then runs, on those inputs, the recorded program through Q1
(``stark/interp.py``, ``csrc/constraints.cu``) and the eager evaluator
(``stark/prover.py`` ``evaluate_quotient_eager``): both outputs must be
equal bit for bit; it prints each one's ms (CUDA events, Q1's kernel alone
and the whole ``evaluate_quotient`` of each), the extra device memory each
call takes at its peak, and Q1's bound. Then two timed ``prove_program``
calls with their peak memory and one traced call's "evaluate constraints"
span per AIR. Ends with one JSON line of the numbers. Needs one CUDA device.

``--parent DIR`` (the root of an earlier checkout, as for ``bench_kernels
--parent``) also runs that checkout's Q1 on the same inputs, in turns with
this one's (earlier, this, this, earlier), holds the two outputs equal and
prints both times, the extra device memory of each launch and this Q1's
launch setting. ``--sweep`` times this Q1 under every setting of
:data:`SWEEP` (points a thread, threads a block, on-chip slots, off-chip
budget) on each AIR's inputs, each output held equal to the default's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from pathlib import Path

from .bench_kernels import HBM_BYTES_PER_S, INT32_MULS_PER_MUL, Tree, in_turns, int32_mul_rate, time_ms
from .stark import MIDEN_PARAMS, interp, prover
from .utils import cuda
from .utils.tracing import Recorder
from .vm import assemble
from .vm.prove import prove_program

FIB_18 = "begin push.0 push.1 repeat.84000 swap dup.1 add end swap drop swap drop end"


def log(msg: str) -> None:
    print(msg, flush=True)


def program_work(prog, inp) -> tuple:
    """(bytes, 32-bit multiplies) one run of ``prog`` needs at least: every
    per-point input column read once (a next row is another point's current
    row), the scalar block read once, the (nd, 2) output written once; every
    MUL instruction a general Goldilocks product at every point."""
    cols = sum(
        (src.shape[0] if s == 3 else src.shape[1]) for s, src in enumerate(inp.sources) if src is not None
    )
    n_bytes = 8 * (inp.nd * cols + inp.scal.numel() + 2 * inp.nd)
    n_mul = int((prog.code[: prog.n_instr, 0] == interp.OP_MUL).sum())
    return n_bytes, n_mul * INT32_MULS_PER_MUL * inp.nd


def bound_ms(prog, inp, mul_rate: float) -> tuple:
    """Q1's least ms for one run and what bounds it ("bytes" or "operations")."""
    n_bytes, ops = program_work(prog, inp)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / mul_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


#: Q1 settings ``--sweep`` times: points a thread x threads a block x on-chip
#: slots, the off-chip remainder uncut (1 GiB); then the five fastest again
#: with the remainder held to 32 MiB, well inside the 50 MB L2
SWEEP = [interp.Q1Setting(k, b, on, 1 << 30) for k in (1, 2, 4) for b in (32, 64, 128, 256)
         for on in (0, 8, 16, 32, 48, 96)]


def sweep(prog, inp, reps: int) -> list:
    """[(setting, ms or None where no block of it fits an SM, plan)] of Q1
    over ``inp`` under each setting of SWEEP and, for the five fastest,
    again with the off-chip remainder held to 32 MiB; every output equal to
    the default setting's."""
    want = interp.run_program_kernel(prog, inp)
    out = []

    def run(setting):
        try:
            plan = interp.q1_plan(prog, inp.nd, setting)
        except cuda.KernelError:
            out.append((setting, None, None))
            return
        if not torch.equal(interp.run_program_kernel(prog, inp, setting), want):
            raise AssertionError(f"Q1 under {setting} disagrees with the default setting")
        out.append((setting, time_ms(lambda: interp.run_program_kernel(prog, inp, setting), reps), plan))

    for setting in SWEEP:
        run(setting)
    best = sorted((r for r in out if r[1] is not None), key=lambda r: r[1])[:5]
    for setting, _, _ in best:
        run(dataclasses.replace(setting, spill_bytes=32 << 20))
    return out


def parent_q1(tree: Tree, prog, inp):
    """The earlier checkout's Q1 on this checkout's inputs, as a call: its
    own program for the same AIR class and counts, its own ProgramInputs."""
    air = prog.air
    their_air = getattr(tree.mod(type(air).__module__.split(".", 1)[1]), type(air).__name__)()
    their = tree.mod("stark.interp")
    their_prog = their.get_program(their_air, prog.n_pub, prog.n_rand, prog.n_auxv)
    their_inp = their.ProgramInputs(sources=inp.sources, scal=inp.scal, nd=inp.nd, next_offset=inp.next_offset)
    return lambda: their.run_program_kernel(their_prog, their_inp)


def capture_quotient_inputs(fn) -> list:
    """Runs ``fn`` with ``prover.evaluate_quotient`` watched; returns the
    arguments of every call that went through a recorded program on the
    card."""
    calls = []
    real = prover.evaluate_quotient

    def watched(air, domain, main_lde, aux_lde, log_d, *rest):
        if main_lde.is_cuda and prover.uses_program(air, domain.trace_height, log_d):
            calls.append((air, domain, main_lde, aux_lde, log_d, *rest))
        return real(air, domain, main_lde, aux_lde, log_d, *rest)

    prover.evaluate_quotient = watched
    try:
        fn()
    finally:
        prover.evaluate_quotient = real
    return calls


def extra_peak_gib(fn) -> float:
    """Device memory ``fn`` allocates at its peak beyond what was held before."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", type=Path, help="root of an earlier checkout: A/B of its Q1 against this one")
    ap.add_argument("--sweep", action="store_true", help="time this Q1 under every setting of SWEEP")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_quotient: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    program = assemble(FIB_18)
    mul_rate = int32_mul_rate()

    def prove():  # eager: the spans and the captured inputs are those of each stage
        return prove_program(program, params=MIDEN_PARAMS, device="cuda", fused=False)[1]

    prove()  # builds the kernels, warms the allocator
    calls = capture_quotient_inputs(prove)
    parent = Tree(args.parent.resolve(), "parent_miden_tpu_torch") if args.parent else None
    rows, sweeps = [], {}
    for call in calls:
        air, domain, log_d = call[0], call[1], call[4]
        name, nd = type(air).__name__, domain.trace_height << log_d
        prog, inp, _ = prover.quotient_program_inputs(*call)
        plan = interp.q1_plan(prog, nd)
        q1 = lambda: interp.run_program_kernel(prog, inp)  # noqa: E731
        q1_ms = time_ms(q1, args.reps)
        prog_ms = time_ms(lambda: prover.evaluate_quotient_program(*call), args.reps)
        eager_ms = time_ms(lambda: prover.evaluate_quotient_eager(*call), 2)
        q1_gib = extra_peak_gib(lambda: prover.evaluate_quotient_program(*call))
        eager_gib = extra_peak_gib(lambda: prover.evaluate_quotient_eager(*call))
        if not torch.equal(prover.evaluate_quotient_program(*call), prover.evaluate_quotient_eager(*call)):
            raise AssertionError(f"{name}: Q1 and the eager evaluator disagree")
        b_ms, b_by = bound_ms(prog, inp, mul_rate)
        row = {"air": name, "points": nd, "instructions": prog.n_instr, "frame": prog.frame_size,
               "scheduled_instructions": plan.sched.n_instr, "scheduled_frame": plan.sched.frame_size,
               "schedule_per_point": {k: getattr(plan.sched, k) for k in (
                   "stores", "frame_reads", "prev_reads", "on_chip_accesses", "input_reads")},
               "launch": plan.describe(), "q1_ms": round(q1_ms, 4),
               "program_ms": round(prog_ms, 4), "eager_ms": round(eager_ms, 4),
               "q1_extra_gib": round(q1_gib, 3), "eager_extra_gib": round(eager_gib, 3),
               "bound_ms": round(b_ms, 4), "bound_by": b_by}
        log(f"{name} at {nd} points ({prog.n_instr} instructions, {prog.frame_size} frame slots; scheduled "
            f"{plan.sched.n_instr} and {plan.sched.frame_size}; launch {plan.describe()}): Q1 {q1_ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / q1_ms:.1f} %), evaluate_quotient through Q1 "
            f"{prog_ms:.4f} ms, eager {eager_ms:.4f} ms; extra peak {q1_gib:.3f} GiB through Q1, "
            f"{eager_gib:.3f} GiB eager; outputs equal")
        if parent is not None:
            old = parent_q1(parent, prog, inp)
            if not torch.equal(old(), q1()):
                raise AssertionError(f"{name}: the parent's Q1 and this Q1 disagree")
            old_ms, new_ms = in_turns(old, q1, args.reps)
            old_gib, new_gib = extra_peak_gib(old), extra_peak_gib(q1)
            row["parent"] = {"q1_ms": round(old_ms, 4), "this_q1_ms": round(new_ms, 4),
                             "q1_extra_gib": round(old_gib, 4), "this_q1_extra_gib": round(new_gib, 4)}
            log(f"  A/B in turns: parent Q1 {old_ms:.4f} ms ({100 * b_ms / old_ms:.1f} % of bound), this Q1 "
                f"{new_ms:.4f} ms ({100 * b_ms / new_ms:.1f} %), {old_ms / new_ms:.2f}x; extra peak of one launch "
                f"{old_gib:.4f} / {new_gib:.4f} GiB; outputs equal")
            del old  # it holds the captured LDEs
        if args.sweep:
            sweeps[name] = []
            for setting, ms, p in sweep(prog, inp, args.reps):
                sweeps[name].append({"setting": dataclasses.asdict(setting), "ms": ms and round(ms, 4),
                                     "launch": p and p.describe()})
                log(f"  sweep {setting}: " + (f"{ms:.4f} ms, {p.describe()}" if ms else "no block fits an SM"))
        rows.append(row)
    del calls, call, prog, inp, q1  # the captured LDEs: the proofs below start without them

    times, peaks = [], []
    for _ in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
    with Recorder() as rec:
        prove()
    spans = {air: round(v[0], 4) for (span_name, air), v in rec.by_air.items()
             if span_name == "evaluate constraints"}
    log(f"vm-fib-18 prove_program {', '.join(f'{t:.4f}' for t in times)} s, peak "
        f"{', '.join(f'{p:.3f}' for p in peaks)} GiB; evaluate constraints (traced) "
        f"{rec.totals['evaluate constraints'][0]:.4f} s: {spans}")
    log(json.dumps({"card": card, "airs": rows, "sweep": sweeps, "prove_s": [round(t, 4) for t in times],
                    "peak_gib": [round(p, 3) for p in peaks], "evaluate_constraints_s": spans}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
