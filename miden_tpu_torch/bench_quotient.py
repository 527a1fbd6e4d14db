"""The quotient on the card: Q1 against the eager evaluator, per VM AIR.

    python3 -m miden_tpu_torch.bench_quotient [--reps 5]

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
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .bench_kernels import HBM_BYTES_PER_S, INT32_MULS_PER_MUL, int32_mul_rate, time_ms
from .stark import MIDEN_PARAMS, interp, prover
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

    def prove():
        return prove_program(program, params=MIDEN_PARAMS, device="cuda")[1]

    prove()  # builds the kernels, warms the allocator
    calls = capture_quotient_inputs(prove)
    rows = []
    for call in calls:
        air, domain, log_d = call[0], call[1], call[4]
        name, nd = type(air).__name__, domain.trace_height << log_d
        prog, inp, _ = prover.quotient_program_inputs(*call)
        q1_ms = time_ms(lambda: interp.run_program_kernel(prog, inp), args.reps)
        prog_ms = time_ms(lambda: prover.evaluate_quotient_program(*call), args.reps)
        eager_ms = time_ms(lambda: prover.evaluate_quotient_eager(*call), 2)
        q1_gib = extra_peak_gib(lambda: prover.evaluate_quotient_program(*call))
        eager_gib = extra_peak_gib(lambda: prover.evaluate_quotient_eager(*call))
        if not torch.equal(prover.evaluate_quotient_program(*call), prover.evaluate_quotient_eager(*call)):
            raise AssertionError(f"{name}: Q1 and the eager evaluator disagree")
        b_ms, b_by = bound_ms(prog, inp, mul_rate)
        row = {"air": name, "points": nd, "instructions": prog.n_instr, "frame": prog.frame_size,
               "threads": interp.q1_threads(prog, nd), "q1_ms": round(q1_ms, 4),
               "program_ms": round(prog_ms, 4), "eager_ms": round(eager_ms, 4),
               "q1_extra_gib": round(q1_gib, 3), "eager_extra_gib": round(eager_gib, 3),
               "bound_ms": round(b_ms, 4), "bound_by": b_by}
        rows.append(row)
        log(f"{name} at {nd} points ({prog.n_instr} instructions, {prog.frame_size} frame slots, "
            f"{row['threads']} threads): Q1 {q1_ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}), "
            f"evaluate_quotient through Q1 {prog_ms:.4f} ms, eager {eager_ms:.4f} ms; extra peak "
            f"{q1_gib:.3f} GiB through Q1, {eager_gib:.3f} GiB eager; outputs equal")
    del calls, call, prog, inp  # the captured LDEs: the proofs below start without them

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
    log(json.dumps({"card": card, "airs": rows, "prove_s": [round(t, 4) for t in times],
                    "peak_gib": [round(p, 3) for p in peaks], "evaluate_constraints_s": spans}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
