"""The control of a cell's ``correct``: the program with one guarantee of the
configuration broken must come out not correct.

    python3 benchmarks/control.py --workload <name> --seeds <n> [<n> ...] [--seconds 10]

The port computes exactly in Goldilocks and has no lower precision to
select. What stands in for it is the step below the configuration's
security: the port's own path with one query fewer than the configuration
states (``num_queries`` - 1), which makes every proof cheaper and weaker.
For each seed, in one process, the cell runs at its own size and load (its
warm-up proofs and a window of ``--seconds``) with every proof made that
way, and the reference judges each proof at the configuration's parameters.
Each seed prints one JSON line: the proofs made and the counts compared,
and ``correct``, which has to be false. Needs the card(s) the cell asks for.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path


def weaker(params):
    """The configuration's parameters with one query fewer."""
    return dataclasses.replace(params, num_queries=params.num_queries - 1)


def control_prove(device: str = "cuda"):
    """A stand-in for the cell's prover that proves with :func:`weaker`."""
    from miden_tpu_torch.vm.prove import prove_program

    def prove(program, inputs, params):
        return prove_program(program, inputs, params=weaker(params), device=device)

    return prove


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of a cell's correctness check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks.harness import spec
    from benchmarks.harness.cell import run_cell

    cell = spec.find_cell(args.workload)
    for seed in args.seeds:
        result = run_cell(cell, seed, args.seconds, False, prove=control_prove())
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"],
                          "judged": result["run"]["judged"], "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
