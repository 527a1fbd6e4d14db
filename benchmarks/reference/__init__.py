"""The benchmark's plain reference: it judges each proof the port made.

For a proof of a configuration's program on given stack inputs, the
reference works out the claim itself (the program's digest from its op
list, and the stack outputs from the program's semantics) and verifies the
proof against that claim with its own verifier (:mod:`.verifier`, the
VM's AIRs in :mod:`.vm`). It is plain Python and NumPy: a frozen copy of
the port's host verifier and MAST hashing, which imports nothing of the
port, of ``miden_tpu`` or of JAX, and reads nothing the port made but the
proof bytes it judges.
"""

from __future__ import annotations

import dataclasses
import importlib

from .params import PcsParams
from .proof import ProofFormatError
from .verifier import VerificationError
from .vm.vm_proof import verify_claim, vm_proof_from_bytes


def family(program: dict):
    """The module of the program's family (``programs/<family>.py``)."""
    return importlib.import_module(f"{__name__}.programs.{program['family']}")


def pcs_params(params: dict) -> PcsParams:
    """The protocol parameters a configuration states, every field named."""
    names = {f.name for f in dataclasses.fields(PcsParams)}
    if set(params) != names:
        raise ValueError(f"the configuration's params must name exactly {sorted(names)}")
    return PcsParams(**params)


def judge(proof_bytes: bytes, program: dict, params: dict, stack_inputs: list, program_hash=None) -> dict:
    """Judge one proof: ``{"inputs_wrong", "outputs_wrong", "hash_wrong",
    "rejected"}``, each 0 or 1, and ``"why"``. ``rejected`` is 1 where the
    proof does not verify against the claim the reference works out (the
    inputs that were sent, the outputs the program must give, the
    program's digest); the other three say which part of the proof's own
    claim differs from it. ``program_hash``, when given, is the digest this
    reference already worked out for ``program``."""
    fam = family(program)
    want_hash = tuple(program_hash) if program_hash is not None else fam.program_hash(program)
    want_in = [v % (2**64 - 2**32 + 1) for v in stack_inputs]
    want_out = fam.stack_outputs(program, want_in)
    out = {"inputs_wrong": 1, "outputs_wrong": 1, "hash_wrong": 1, "rejected": 1, "why": ""}
    try:
        proof = vm_proof_from_bytes(proof_bytes)
    except ProofFormatError as e:
        out["why"] = f"unreadable: {e}"
        return out
    out["inputs_wrong"] = int(list(proof.stack_inputs) != want_in)
    out["outputs_wrong"] = int(list(proof.stack_outputs) != want_out)
    out["hash_wrong"] = int(tuple(proof.program_hash) != want_hash)
    try:
        verify_claim(proof, pcs_params(params), want_hash, want_in, want_out)
    except (VerificationError, ProofFormatError, ValueError) as e:
        out["why"] = f"{type(e).__name__}: {e}"
        return out
    out["rejected"] = 0
    return out
