"""An execution proof of the VM and its verification against a claim.

A copy of the verifier half of the port's ``vm/prove.py``: the wire form
of ``VmProof`` (program hash, stack inputs and outputs, kernel digests,
deferred root and wire, then the STARK proof), the VM's multi-AIR with its
cross-AIR LogUp balance, and :func:`verify_claim`, which verifies the STARK
proof against a claim the caller worked out for itself rather than the one
the proof carries. Only programs that log no deferred (precompile) claims
are accepted, as the benchmark's programs are.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .. import gl
from ..air import MultiAir
from ..params import PcsParams
from ..proof import Proof, ProofFormatError, Statement, proof_from_bytes
from ..transcript import DuplexChallenger, TranscriptError
from ..verifier import VerificationError, verify
from .ace_registry import relation_seed
from .chiplets_air import ChipletsVmAir
from .core_air import CoreVmAir
from .poseidon2_air import Poseidon2PermutationAir

MIN_STACK_DEPTH = 16
MAGIC = b"MVMP"
VERSION = 3
#: the largest deferred wire ``VmProof.from_bytes`` reads (vm/deferred.py)
MAX_WIRE_BYTES = 1 << 24


@dataclass
class VmProof:
    """An execution proof: program hash + public stack values + STARK."""

    program_hash: tuple
    stack_inputs: list  # padded to 16, top first
    stack_outputs: list  # 16 values, top first
    kernel_digests: tuple
    stark: Proof
    deferred_root: tuple
    deferred_wire: bytes | None


def vm_proof_from_bytes(data: bytes) -> VmProof:
    """Parse an execution proof; raises :class:`ProofFormatError` on any
    malformed input."""
    try:
        return _from_bytes(data)
    except ProofFormatError:
        raise
    except (struct.error, IndexError, ValueError) as e:
        raise ProofFormatError(f"malformed execution proof: {e}") from e


def _from_bytes(data: bytes) -> VmProof:
    if data[:4] != MAGIC:
        raise ProofFormatError("bad execution-proof magic")
    (version,) = struct.unpack_from("<I", data, 4)
    if version != VERSION:
        raise ProofFormatError(f"unsupported proof version {version}")
    off = 8

    def read_felts(n):
        nonlocal off
        vals = struct.unpack_from(f"<{n}Q", data, off)
        off += 8 * n
        if any(v >= gl.P for v in vals):
            raise ProofFormatError("non-canonical field element")
        return list(vals)

    ph = tuple(read_felts(4))
    dr = tuple(read_felts(4))
    sin = read_felts(16)
    sout = read_felts(16)
    (n_kernel,) = struct.unpack_from("<I", data, off)
    off += 4
    if n_kernel > 4096:
        raise ProofFormatError("implausible kernel size")
    kernel = tuple(tuple(read_felts(4)) for _ in range(n_kernel))
    (n_wire,) = struct.unpack_from("<I", data, off)
    off += 4
    if n_wire > MAX_WIRE_BYTES:
        raise ProofFormatError("implausible deferred wire size")
    wire = bytes(data[off : off + n_wire]) if n_wire else None
    off += n_wire
    return VmProof(ph, sin, sout, kernel, proof_from_bytes(data[off:]), dr, wire)


class VmMultiAir(MultiAir):
    """VM AIRs with the cross-AIR LogUp balance: the committed final
    accumulator values of all AIRs plus the verifier's public boundary
    insertions (one KERNEL_PROC_INIT fraction per declared kernel digest,
    docs kernel_rom.md) must sum to zero — the STARK analog of
    MidenMultiAir::eval_external (air/src/lib.rs)."""

    def __init__(self, airs, kernel_digests=(), deferred_root=(0, 0, 0, 0)):
        super().__init__(airs)
        self.kernel_digests = tuple(tuple(d) for d in kernel_digests)
        self.deferred_root = tuple(v % gl.P for v in deferred_root)

    def eval_external(self, randomness, aux_values, log_heights):
        from .buses import BUS_CHIPLET, BUS_DEFERRED, W
        from .chiplets import OP_KERNEL_PROC_INIT

        total = (0, 0)
        for vals in aux_values:
            for v in vals:
                total = gl.ext_add(total, (int(v[0]), int(v[1])))
        alpha = tuple(int(x) for x in randomness[0])
        beta = tuple(int(x) for x in randomness[1])
        beta_pows = [(1, 0)]
        for _ in range(W):
            beta_pows.append(gl.ext_mul(beta_pows[-1], beta))

        def msg(bus, elems):
            d = gl.ext_add(alpha, gl.ext_mul_base(beta_pows[W], bus + 1))
            for i, e in enumerate(elems):
                d = gl.ext_add(d, gl.ext_mul_base(beta_pows[i], e % gl.P))
            return d

        for digest in self.kernel_digests:
            total = gl.ext_add(
                total,
                gl.ext_inv(msg(BUS_CHIPLET, [OP_KERNEL_PROC_INIT, *digest])),
            )
        # deferred-root chain terminals (air lookup/miden_air.rs:60-62):
        # +1/d(zero root) - 1/d(final root); cancel when no LOGDEFERRED ran
        if any(self.deferred_root):
            total = gl.ext_add(
                total, gl.ext_inv(msg(BUS_DEFERRED, [0, 0, 0, 0]))
            )
            total = gl.ext_sub(
                total, gl.ext_inv(msg(BUS_DEFERRED, list(self.deferred_root)))
            )
        return [total]


def vm_statement(
    program_hash, stack_inputs, stack_outputs, kernel_digests=(),
    deferred_root=(0, 0, 0, 0),
) -> Statement:
    publics = (
        list(stack_inputs) + list(stack_outputs) + list(program_hash)
        + list(deferred_root)
    )
    if len(publics) != 40:
        raise VerificationError("the VM statement has 40 public values")
    return Statement(
        VmMultiAir(
            [CoreVmAir(), ChipletsVmAir(), Poseidon2PermutationAir()],
            kernel_digests,
            deferred_root,
        ),
        publics,
        aux_inputs=[e % gl.P for d in kernel_digests for e in d],
    )


def protocol_seed() -> list:
    """The Fiat-Shamir seed of the VM protocol: the relation digest of the
    VM AIRs' ACE circuits (``vm/ace_registry.py``)."""
    return list(relation_seed())


def verify_claim(proof: VmProof, params: PcsParams, program_hash, stack_inputs, stack_outputs) -> None:
    """Verify ``proof``'s STARK against the claim ``(program_hash,
    stack_inputs, stack_outputs)`` with no kernel and no deferred claims
    (verifier/src/lib.rs:99). Raises :class:`VerificationError` on any
    failure, a claim the proof does not carry among them."""
    claim = (tuple(program_hash), list(stack_inputs), list(stack_outputs))
    if len(claim[1]) != MIN_STACK_DEPTH or len(claim[2]) != MIN_STACK_DEPTH:
        raise VerificationError("stack inputs and outputs must have 16 entries")
    if (tuple(proof.program_hash), list(proof.stack_inputs), list(proof.stack_outputs)) != claim:
        raise VerificationError("the proof carries another claim")
    if proof.kernel_digests or any(proof.deferred_root) or proof.deferred_wire is not None:
        raise VerificationError("the proof binds a kernel or deferred claims")
    statement = vm_statement(*claim)
    try:
        verify(params, statement, proof.stark, DuplexChallenger(protocol_seed()))
    except TranscriptError as e:
        raise VerificationError(str(e)) from e
