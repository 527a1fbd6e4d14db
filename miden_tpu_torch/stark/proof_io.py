"""Proof serialization.

The reference serializes ``StarkProofData { log_trace_heights, transcript }``
with wincode (prover/src/lib.rs:347-353) under a 64 MiB cap
(verifier/src/lib.rs:22). This framework uses an equivalent explicit little-
endian layout:

    magic  b"MTPU"  | version u32 | n_airs u32 | log_heights u8 × n_airs
    n_fields u64    | fields u64 × n_fields
    n_commitments u64 | commitments (4 × u64) × n_commitments
"""

from __future__ import annotations

import struct

import numpy as np

from ..field import gl
from ..transcript.challenger import TranscriptData
from .prover import Proof

MAGIC = b"MTPU"
VERSION = 1
MAX_PROOF_BYTES = 64 * 1024 * 1024  # mirror the reference's 64 MiB cap


class ProofFormatError(ValueError):
    pass


def proof_to_bytes(proof: Proof) -> bytes:
    fields, commitments = proof.data.to_arrays()
    out = bytearray()
    out += MAGIC
    out += struct.pack("<II", VERSION, len(proof.log_heights))
    out += bytes(proof.log_heights)
    out += struct.pack("<Q", fields.size)
    out += fields.astype("<u8").tobytes()
    out += struct.pack("<Q", commitments.shape[0])
    out += commitments.astype("<u8").tobytes()
    return bytes(out)


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
