"""The STARK statement and proof, and the proof's wire form.

The port's explicit little-endian layout of ``StarkProofData {
log_trace_heights, transcript }`` (the reference serializes it with
wincode, prover/src/lib.rs:347-353, under a 64 MiB cap):

    magic  b"MTPU"  | version u32 | n_airs u32 | log_heights u8 × n_airs
    n_fields u64    | fields u64 × n_fields
    n_commitments u64 | commitments (4 × u64) × n_commitments

A copy of ``Statement``, ``Proof`` and ``proof_order`` of the port's
``stark/prover.py`` and of its ``stark/proof_io.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import gl
from .air import MultiAir
from .transcript import TranscriptData


@dataclass
class Statement:
    """Verifier-visible statement: the AIRs + shared public inputs."""

    multi_air: MultiAir
    publics: list
    aux_inputs: list = field(default_factory=list)

    def observe(self, challenger, log_heights) -> None:
        """FS binding of statement + shape (prover/mod.rs:284-292)."""
        self.multi_air.observe(challenger, self.publics, self.aux_inputs)
        challenger.observe(len(self.multi_air.airs))
        for lh in log_heights:
            challenger.observe(lh)


@dataclass
class Proof:
    log_heights: list  # instance order
    data: TranscriptData

    def size_in_bytes(self) -> int:
        return self.data.size_in_bytes() + len(self.log_heights)


def proof_order(log_heights: list) -> list:
    """Instance indices sorted by (log_height, instance index) ascending."""
    return sorted(range(len(log_heights)), key=lambda i: (log_heights[i], i))


MAGIC = b"MTPU"
VERSION = 1
MAX_PROOF_BYTES = 64 * 1024 * 1024  # mirror the reference's 64 MiB cap


class ProofFormatError(ValueError):
    pass


def proof_from_bytes(data: bytes) -> Proof:
    if len(data) > MAX_PROOF_BYTES:
        raise ProofFormatError("proof exceeds 64 MiB cap")
    if data[:4] != MAGIC:
        raise ProofFormatError("bad magic")
    version, n_airs = struct.unpack_from("<II", data, 4)
    if version != VERSION:
        raise ProofFormatError(f"unsupported version {version}")
    off = 12
    if off + n_airs > len(data):
        raise ProofFormatError("truncated log_heights")
    log_heights = list(data[off : off + n_airs])
    off += n_airs
    (n_fields,) = struct.unpack_from("<Q", data, off)
    off += 8
    end = off + 8 * n_fields
    if end > len(data):
        raise ProofFormatError("truncated field stream")
    fields = np.frombuffer(data, dtype="<u8", count=n_fields, offset=off)
    off = end
    (n_comm,) = struct.unpack_from("<Q", data, off)
    off += 8
    end = off + 32 * n_comm
    if end != len(data):
        raise ProofFormatError("trailing or truncated commitment stream")
    comm = np.frombuffer(data, dtype="<u8", count=4 * n_comm, offset=off).reshape(
        n_comm, 4
    )
    for arr in (fields, comm.ravel()):
        if arr.size and int(arr.max()) >= gl.P:
            raise ProofFormatError("non-canonical field element")
    return Proof(
        log_heights=log_heights,
        data=TranscriptData.from_arrays(fields, comm),
    )
