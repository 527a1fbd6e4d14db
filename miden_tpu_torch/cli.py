"""Command-line interface: compile / run / prove / verify MASM programs.

Port of ``miden_tpu/cli.py``, which mirrors the reference CLI surface
(miden-vm/src/main.rs:96 `miden-vm {compile, run, prove, verify}` with JSON
input files carrying operand/advice stacks, miden-vm/src/internal.rs:30-45).
It prints the same program hashes and output stacks and writes the same
bytes as ``python -m miden_tpu``.

Usage:
    python -m miden_tpu_torch compile program.masm [-o program.mast]
    python -m miden_tpu_torch run program.masm [-i inputs.json] [--device cpu]
    python -m miden_tpu_torch prove program.masm [-i inputs.json] -o proof.bin [--device cpu]
    python -m miden_tpu_torch verify proof.bin [--device cpu]

``prove`` proves on the card unless ``--device cpu`` is given. ``run`` and
``verify`` work on the host; they check the device all the same, so that a
missing card is reported alike by every subcommand (there is no fallback
to the CPU).

Input file (JSON): {"operand_stack": ["1", "2"], "advice_stack": ["3"]}
(decimal or 0x-hex strings; operand_stack[0] is the top of the stack).
Optional: "advice_map": {"<hex key>": ["v", ...]}. A kernel module can be
supplied with --kernel kernel.masm.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _parse_felt(v) -> int:
    if isinstance(v, int):
        return v
    return int(str(v), 0)


def _load_inputs(path: str | None):
    from .vm.processor import AdviceProvider

    if path is None:
        return [], AdviceProvider()
    data = json.loads(Path(path).read_text())
    operand = [_parse_felt(v) for v in data.get("operand_stack", [])]
    advice = AdviceProvider(
        stack=[_parse_felt(v) for v in data.get("advice_stack", [])]
    )
    for key, values in data.get("advice_map", {}).items():
        raw = bytes.fromhex(key)
        k = tuple(
            int.from_bytes(raw[i : i + 8], "little") for i in range(0, 32, 8)
        )
        advice.map[k] = [_parse_felt(v) for v in values]
    return operand, advice


def _check_device(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {device}; pass --device cpu to run on the CPU")


def _assemble(args):
    from .vm.assembler import Assembler

    kernel = Path(args.kernel).read_text() if args.kernel else None
    asm = Assembler(kernel=kernel)
    return asm.assemble_program(Path(args.program).read_text())


def cmd_compile(args) -> int:
    program = _assemble(args)
    digest = program.forest[program.entrypoint].digest
    print("program hash:", " ".join(f"{v:016x}" for v in digest))
    if getattr(args, "output", None):
        from .vm.mast_io import program_to_bytes

        blob = program_to_bytes(program)
        Path(args.output).write_bytes(blob)
        print(f"wrote {len(blob)} bytes to {args.output}")
    return 0


def cmd_run(args) -> int:
    from .vm.trace import execute_and_trace

    _check_device(args.device)
    program = _assemble(args)
    operand, advice = _load_inputs(args.input)
    t0 = time.time()
    out, trace = execute_and_trace(program, operand, advice)
    print(f"executed {trace.num_real_rows} cycles in {time.time() - t0:.3f}s")
    print("output stack:", out.stack)
    return 0


def cmd_prove(args) -> int:
    from .vm.prove import prove_program

    _check_device(args.device)
    program = _assemble(args)
    operand, advice = _load_inputs(args.input)
    t0 = time.time()
    out, proof = prove_program(program, operand, advice, device=args.device)
    elapsed = time.time() - t0
    blob = proof.to_bytes()
    Path(args.output).write_bytes(blob)
    print(f"proved in {elapsed:.2f}s — {len(blob)} byte proof → {args.output}")
    print("output stack:", out.stack)
    print("program hash:", " ".join(f"{v:016x}" for v in proof.program_hash))
    return 0


def cmd_verify(args) -> int:
    from .stark.verifier import VerificationError
    from .vm.prove import VmProof, verify_program

    _check_device(args.device)
    blob = Path(args.proof).read_bytes()
    proof = VmProof.from_bytes(blob)
    t0 = time.time()
    try:
        verify_program(proof)
    except VerificationError as e:
        print(f"VERIFICATION FAILED: {e}")
        return 1
    print(f"proof verified in {time.time() - t0:.3f}s")
    print("program hash:", " ".join(f"{v:016x}" for v in proof.program_hash))
    print("output stack:", proof.stack_outputs)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="miden_tpu_torch", description="Miden VM prover in PyTorch on an NVIDIA GPU"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, program=True):
        if program:
            p.add_argument("program", help="MASM source file")
            p.add_argument("--kernel", help="kernel MASM module", default=None)

    def device(p):
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda): prove runs there; run and verify only check it")

    p = sub.add_parser("compile", help="assemble and print the program hash")
    common(p)
    p.add_argument(
        "-o", "--output", default=None,
        help="write the compiled MAST program (budgeted wire form)",
    )
    p.set_defaults(fn=cmd_compile)

    p = sub.add_parser("run", help="execute without proving")
    common(p)
    p.add_argument("-i", "--input", help="JSON input file", default=None)
    device(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("prove", help="execute and produce a STARK proof")
    common(p)
    p.add_argument("-i", "--input", help="JSON input file", default=None)
    p.add_argument("-o", "--output", help="proof output path", default="proof.bin")
    device(p)
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("verify", help="verify an execution proof")
    p.add_argument("proof", help="proof file")
    device(p)
    p.set_defaults(fn=cmd_verify)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
