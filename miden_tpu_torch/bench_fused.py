"""One-shot proofs on the card: an A/B/A/B alternation of two proof shapes.

    python3 -m miden_tpu_torch.bench_fused [--parent DIR] [--rounds 2]

A is vm-fib-18 (bench.py's real-program row, the fib program with
repeat.84000, at MIDEN_PARAMS), B the same program under
``hash_name="rpo256"``. The fused prover (``stark/fused.py``) keeps the plan
of one shape, so in an alternation every proof is the first of its shape
since the last: a one-shot proof, whose phases run eagerly and are never
captured. This is what the CLI, the session and every shape proved once
pay.

Each run is a process of its own: it proves A and B once (the first-time
costs: library loads, constant tables), then A, B, A, B, each timed with
the host clock around ``prove_program`` (synchronized), and prints the four
times, their sum and the card's reserved memory. The runs: this checkout on
the default path and with ``fused=False``, and with ``--parent DIR`` (the
root of an earlier checkout) that checkout's default path, in turns
(parent, this, this with ``fused=False``), ``--rounds`` times. Ends with one
JSON line of the numbers. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FIB = "begin push.0 push.1 repeat.84000 swap dup.1 add end swap drop swap drop end"

#: one run, in a process of its own: argv root, program, "default" | "eager"
CHILD = r"""
import dataclasses, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from miden_tpu_torch.utils import cuda
cuda.build_all()
from miden_tpu_torch.stark import MIDEN_PARAMS
from miden_tpu_torch.vm import assemble
from miden_tpu_torch.vm.prove import prove_program
program = assemble(sys.argv[2])
kw = {} if sys.argv[3] == "default" else {"fused": False}
shapes = (MIDEN_PARAMS, dataclasses.replace(MIDEN_PARAMS, hash_name="rpo256"))
for params in shapes:
    prove_program(program, params=params, **kw)
secs = []
for params in shapes * 2:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prove_program(program, params=params, **kw)
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
print(json.dumps({"secs": secs, "reserved_gib": torch.cuda.memory_reserved() / 2**30}))
"""


def run(root: Path, mode: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(root), FIB, mode],
        capture_output=True, text=True, cwd=root, timeout=900,
    )
    if out.returncode != 0:
        raise RuntimeError(f"the run of {root} ({mode}) failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="root of an earlier checkout: its default path in turns")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    this = Path(__file__).resolve().parents[1]
    runs = [("parent", args.parent.resolve(), "default")] if args.parent else []
    runs += [("this", this, "default"), ("this, fused=False", this, "eager")]
    results: dict = {label: [] for label, _, _ in runs}
    for r in range(args.rounds):
        for label, root, mode in runs:
            res = run(root, mode)
            results[label].append(res)
            print(f"round {r} {label}: A B A B {' '.join(f'{t:.4f}' for t in res['secs'])} s, sum "
                  f"{sum(res['secs']):.4f} s, reserved {res['reserved_gib']:.3f} GiB", flush=True)
    sums = {label: [round(sum(res["secs"]), 4) for res in rs] for label, rs in results.items()}
    print(f"card: {card}; sums of A B A B by run: {sums}", flush=True)
    print(json.dumps({"card": card, "runs": results, "sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
