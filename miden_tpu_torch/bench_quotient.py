"""The quotient's block size on the card: the VM proof at each block log.

    python3 -m miden_tpu_torch.bench_quotient [--logs 18 19 20] [--rounds 2]

Proves bench.py's real-program row (the fib program with repeat.84000:
core 2^18 rows, a 2^21-point quotient domain) at MIDEN_PARAMS with
``stark.prover.QUOTIENT_BLOCK_LOG`` set to each log in turn. After one
warm-up at each log, every round gives, for each log: one timed
``prove_program`` (host clock around the whole call) with its peak device
memory, and one traced call for its "evaluate constraints" span. A log
that runs out of device memory is reported as such and dropped. The proof
bytes must not depend on the block size. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from .stark import MIDEN_PARAMS
from .stark import prover
from .utils.tracing import Recorder
from .vm import assemble
from .vm.prove import prove_program

FIB_18 = "begin push.0 push.1 repeat.84000 swap dup.1 add end swap drop swap drop end"


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logs", type=int, nargs="+", default=[18, 19, 20])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_quotient: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    program = assemble(FIB_18)
    default = prover.QUOTIENT_BLOCK_LOG

    def prove(block_log):
        prover.QUOTIENT_BLOCK_LOG = block_log
        try:
            return prove_program(program, params=MIDEN_PARAMS, device="cuda")[1].to_bytes()
        finally:
            prover.QUOTIENT_BLOCK_LOG = default

    logs, blobs = [], {}
    for block_log in args.logs:
        try:
            blobs[block_log] = prove(block_log)
            logs.append(block_log)
        except torch.cuda.OutOfMemoryError as e:
            log(f"2^{block_log}: out of device memory in the warm-up ({str(e).splitlines()[0]})")
        torch.cuda.empty_cache()
    if len(set(blobs.values())) > 1:
        raise AssertionError(f"the proof bytes depend on the block size: {sorted(blobs)}")

    rows = {b: {"s": [], "eval": [], "peak": []} for b in logs}
    for _ in range(args.rounds):
        for block_log in logs:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prove(block_log)
            torch.cuda.synchronize()
            rows[block_log]["s"].append(time.perf_counter() - t0)
            rows[block_log]["peak"].append(torch.cuda.max_memory_allocated() / 2**30)
            with Recorder() as rec:
                prove(block_log)
            rows[block_log]["eval"].append(rec.totals["evaluate constraints"][0])
    for block_log in logs:
        r = rows[block_log]
        log(f"2^{block_log} points per block: prove_program median {statistics.median(r['s']):.4f} s "
            f"(runs {', '.join(f'{t:.4f}' for t in r['s'])}), evaluate constraints (traced) median "
            f"{statistics.median(r['eval']):.4f} s (runs {', '.join(f'{t:.4f}' for t in r['eval'])}), "
            f"peak memory {max(r['peak']):.3f} GiB")
    log(f"proof bytes equal at every block size ({len(next(iter(blobs.values())))} bytes); on {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
