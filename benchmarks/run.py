"""The benchmark of ``miden_tpu_torch``: one run of one cell.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. It sets up (kernel libraries into ``miden_tpu_torch/_build``, the
program, the warm-up proofs), proves for ``--seconds`` in a closed loop,
judges every proof with the reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` (each number
compared, with its limit), which is also written as the last lines of
standard error. A line before it says what the run saw. Without the card,
or where the run cannot be measured as the cell asks, it prints no result
and exits with another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks.harness import spec
    from benchmarks.harness.cell import HarnessError, log, run_cell

    cell = spec.find_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA device(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    marks = {"torch": time.perf_counter() - T_START}
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START, marks=marks)
    except HarnessError as e:
        log(f"no result: {e}")
        return 3
    run = result.pop("run")
    print(json.dumps({"run": run, "workload": args.workload, "seed": args.seed}), flush=True)
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
