"""VM proving facade: execute a Miden program and produce a STARK proof
that the execution was correct.

Mirrors the reference facades `prove_sync` (prover/src/lib.rs:117) and
`Verifier::verify` (verifier/src/lib.rs:99): the host executes the MAST
and builds the trace (the trace-generating oracle), the three trace
matrices move to the device, and the port's proving pipeline (LDE → LMCS
commit → LogUp aux → constraint/quotient eval → DEEP → FRI) turns them
into a proof. The verifier needs only the program hash, the claimed stack
inputs/outputs, and the proof. Proofs are byte-equal to ``miden_tpu``'s
for the same program, inputs and parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import gl
from ..stark.params import MIDEN_PARAMS, PcsParams
from ..stark.prover import Proof, Statement
from ..stark.air import MultiAir
from ..transcript.challenger import DuplexChallenger
from ..utils.tracing import span
from . import layout as L
from .constraints import CoreVmAir
from .constraints.chiplets_air import ChipletsVmAir
from .constraints.poseidon2_air import Poseidon2PermutationAir
from .mast import Program
from .processor import AdviceProvider, ExecutionOutput, StackInputs
from .trace import execute_and_trace

# Fiat–Shamir seed for the VM protocol: the relation digest
# Poseidon2([PROTOCOL_ID || ACE registry root]) — the analog of the
# reference's RELATION_DIGEST seeding (air/src/config.rs:89-108). Binds
# every proof to the committed constraint system: tamper with any VM
# constraint (and thus any registry circuit) and the seed moves, so
# proofs against the old relation stop verifying. Computed lazily (the
# registry generates the ACE circuits from the live AIRs on first use).
def protocol_seed() -> list:
    from .ace_registry import relation_seed

    return list(relation_seed())


@dataclass
class VmProof:
    """An execution proof: program hash + public stack values + STARK.

    Serialization mirrors ExecutionProof::{to_bytes, from_bytes}
    (core/src/proof.rs): an explicit little-endian layout over the public
    claim followed by the STARK transcript bytes."""

    program_hash: tuple
    stack_inputs: list[int]  # padded to 16, top first
    stack_outputs: list[int]  # 16 values, top first
    kernel_digests: tuple
    stark: Proof
    deferred_root: tuple = (0, 0, 0, 0)
    # serialized deferred-DAG wire witness (vm/deferred.py
    # DeferredStateWire.to_bytes) justifying deferred_root, when the
    # execution host-registered every logged statement. Partial
    # verification rehydrates it (DeferredProof::Wire,
    # core/src/deferred/wire.rs:1-13); FINAL verification ignores it and
    # requires a session STARK, like the reference's rejection of
    # wire-backed deferred proofs in public verification.
    deferred_wire: bytes | None = None

    MAGIC = b"MVMP"
    VERSION = 3

    def to_bytes(self) -> bytes:
        import struct

        from ..stark.proof_io import proof_to_bytes

        out = bytearray()
        out += self.MAGIC
        out += struct.pack("<I", self.VERSION)
        for v in self.program_hash:
            out += struct.pack("<Q", v % gl.P)
        for v in self.deferred_root:
            out += struct.pack("<Q", v % gl.P)
        for v in self.stack_inputs:
            out += struct.pack("<Q", v % gl.P)
        for v in self.stack_outputs:
            out += struct.pack("<Q", v % gl.P)
        out += struct.pack("<I", len(self.kernel_digests))
        for d in self.kernel_digests:
            for v in d:
                out += struct.pack("<Q", v % gl.P)
        wire = self.deferred_wire or b""
        out += struct.pack("<I", len(wire))
        out += wire
        out += proof_to_bytes(self.stark)
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "VmProof":
        import struct

        from ..stark.proof_io import ProofFormatError, proof_from_bytes

        try:
            return cls._from_bytes(data)
        except ProofFormatError:
            raise
        except (struct.error, IndexError, ValueError) as e:
            # truncated / corrupt containers reject uniformly
            # (fuzz finding, tests/test_fuzz_decoders.py)
            raise ProofFormatError(f"malformed execution proof: {e}") from e

    @classmethod
    def _from_bytes(cls, data: bytes) -> "VmProof":
        import struct

        from ..stark.proof_io import ProofFormatError, proof_from_bytes

        if data[:4] != cls.MAGIC:
            raise ProofFormatError("bad execution-proof magic")
        (version,) = struct.unpack_from("<I", data, 4)
        if version != cls.VERSION:
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
        from .deferred import MAX_WIRE_BYTES

        if n_wire > MAX_WIRE_BYTES:
            raise ProofFormatError("implausible deferred wire size")
        wire = bytes(data[off : off + n_wire]) if n_wire else None
        off += n_wire
        return cls(
            ph, sin, sout, kernel, proof_from_bytes(data[off:]),
            deferred_root=dr, deferred_wire=wire,
        )


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
        from .chiplets import OP_KERNEL_PROC_INIT
        from .constraints.buses import BUS_CHIPLET, BUS_DEFERRED, W

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
    assert len(publics) == 40
    return Statement(
        VmMultiAir(
            [CoreVmAir(), ChipletsVmAir(), Poseidon2PermutationAir()],
            kernel_digests,
            deferred_root,
        ),
        publics,
        aux_inputs=[e % gl.P for d in kernel_digests for e in d],
    )


def trace_program(program: Program, stack_inputs=None, advice: AdviceProvider | None = None, **opts) -> tuple:
    """Execute ``program`` on the host: ``(output, trace, statement,
    traces)``, the last two what :func:`~..stark.prover.prove` takes."""
    with span("execute and trace"):
        out, trace = execute_and_trace(program, stack_inputs, advice, **opts)
    statement = vm_statement(
        trace.program_hash,
        trace.stack_inputs,
        trace.stack_outputs,
        trace.kernel_digests,
        trace.deferred_root,
    )
    return out, trace, statement, [trace.matrix, trace.chiplets, trace.poseidon]


def vm_proof(out: ExecutionOutput, trace, stark_proof) -> "VmProof":
    """The :class:`VmProof` of a traced program and its STARK proof."""
    wire = None
    if out.deferred_state is not None and any(trace.deferred_root):
        wire = out.deferred_state.to_wire().to_bytes()
    return VmProof(
        program_hash=trace.program_hash,
        stack_inputs=list(trace.stack_inputs),
        stack_outputs=list(trace.stack_outputs),
        kernel_digests=tuple(trace.kernel_digests),
        stark=stark_proof,
        deferred_root=tuple(trace.deferred_root),
        deferred_wire=wire,
    )


def prove_program(
    program: Program,
    stack_inputs: list[int] | StackInputs | None = None,
    advice: AdviceProvider | None = None,
    params: PcsParams = MIDEN_PARAMS,
    device="cuda",
    fused: bool | None = None,
    **opts,
) -> tuple[ExecutionOutput, VmProof]:
    """Execute + prove (prover/src/lib.rs:117 prove_sync): the program
    runs on the host, and its three trace matrices are proved on
    ``device`` (the card unless the caller asks for ``"cpu"``). ``fused``
    goes to :func:`~..stark.prover.prove`: None proves through the fused
    phases on the card (CUDA graphs from a shape's second proof on) and
    eagerly on the CPU; True or False forces one path."""
    from ..stark.prover import prove

    out, trace, statement, traces = trace_program(program, stack_inputs, advice, **opts)
    res = prove(params, statement, traces, DuplexChallenger(protocol_seed()), device=device, fused=fused)
    return out, vm_proof(out, trace, res.proof)


def verify_program(
    proof: VmProof,
    params: PcsParams = MIDEN_PARAMS,
    deferred=None,
    partial: bool = False,
) -> None:
    """Verify an execution proof against its public claim
    (verifier/src/lib.rs:99). Raises VerificationError on any failure.

    When the proof binds a non-zero deferred root (the execution logged
    precompile claims via LOGDEFERRED), a matching deferred-session proof
    must be supplied as ``deferred`` and verified against the bound root
    (``precompile.session.verify_deferred``) — the reference's
    `resolve_final_deferred_root` step (verifier/src/lib.rs:99-110).
    ``partial=True`` skips that resolution (`Verifier::verify_partial`,
    verifier/src/lib.rs:46-48): the caller takes responsibility for
    discharging the deferred root later. The session proof comes from
    ``precompile.session.prove_deferred_state_dag(out.deferred_state)``."""
    from ..stark.verifier import VerificationError, verify

    if len(proof.stack_inputs) != L.MIN_STACK_DEPTH:
        raise VerificationError("stack inputs must have 16 entries")
    if len(proof.stack_outputs) != L.MIN_STACK_DEPTH:
        raise VerificationError("stack outputs must have 16 entries")
    if not partial:
        bound = tuple(v % gl.P for v in proof.deferred_root)
        if any(bound):
            if deferred is None:
                raise VerificationError(
                    "proof binds a deferred root; supply the deferred-"
                    "session proof or verify with partial=True"
                )
            from ..precompile.session import verify_deferred

            verify_deferred(deferred, bound, params=params)
        elif deferred is not None:
            raise VerificationError(
                "deferred proof supplied but the execution logged no claims"
            )
    elif proof.deferred_wire is not None:
        # witness-backed partial verification (DeferredProof::Wire,
        # core/src/deferred/wire.rs:89-122): rehydrate the untrusted
        # wire under the default registry and require it to justify the
        # bound root. A wire that fails strict canonical rehydration, or
        # opens a different root, rejects the partial proof.
        from .deferred import (
            DeferredState,
            DeferredStateWire,
            IntegrityError,
            default_registry,
        )

        try:
            st = DeferredState.from_wire(
                default_registry(),
                DeferredStateWire.from_bytes(proof.deferred_wire),
            )
        except IntegrityError as e:
            raise VerificationError(f"deferred wire rejected: {e}") from e
        if st.root != tuple(v % gl.P for v in proof.deferred_root):
            raise VerificationError(
                "deferred wire does not open the bound deferred root"
            )
    statement = vm_statement(
        proof.program_hash,
        proof.stack_inputs,
        proof.stack_outputs,
        proof.kernel_digests,
        proof.deferred_root,
    )
    from ..transcript.challenger import TranscriptError

    try:
        verify(params, statement, proof.stark, DuplexChallenger(protocol_seed()))
    except TranscriptError as e:
        # transcript desync (e.g. a tampered public claim diverges the
        # Fiat–Shamir replay) is a verification failure, one error type
        # for callers (verifier/src/lib.rs VerificationError)
        raise VerificationError(str(e)) from e
