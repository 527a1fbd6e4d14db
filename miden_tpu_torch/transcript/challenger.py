"""Fiat-Shamir duplex challenger + transcript channels (host side).

The same state machine as ``miden_tpu.transcript.challenger``: p3
``DuplexChallenger<Felt, Poseidon2, 12, 8>`` recording into prover/verifier
transcripts. *Sent* values are observed and recorded; *hints* (opened rows,
Merkle siblings) are recorded only; the verifier replays the stream and
enforces an empty tail.

The 12-element state is exact Python ints. Proof-of-work grinding screens
candidate witnesses in batches through the batched Poseidon2 permutation
(:func:`_grind_batch`) and always returns the **smallest** witness.

Duplex semantics (p3): observe buffers into ``input_buffer`` and duplexes at
rate 8; duplexing overwrites ``state[0..len(buffer)]``, permutes and refills
``output_buffer = state[0..8]``; ``sample`` pops from the end of the output
buffer; any observe invalidates buffered output.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gl
from ..field.goldilocks import as_i64, to_torch
from ..hash import poseidon2, poseidon2_host

RATE = 8
WIDTH = 12


def _grind_batch(pos: int, bits: int, batch: int, base: torch.Tensor, start: int):
    """Screen PoW witnesses ``[start, start + batch)`` with one batched
    permutation: lane ``pos`` of the pre-duplex state ``base`` (12,) holds
    the candidate, and the candidate passes when lane 7 (the first sampled
    element) has ``bits`` low zero bits. Returns ``(witness, ok)`` as 0-d
    device tensors: the smallest passing candidate, or ``(start, False)``."""
    ws = torch.arange(start, start + batch, dtype=torch.int64, device=base.device)
    state = base[:, None].expand(WIDTH, batch).clone()
    state[pos] = ws
    lane = poseidon2.permute(state)[RATE - 1]
    ok = (lane & as_i64((1 << bits) - 1)) == 0
    # first maximum: the smallest witness (index_select: no host sync)
    idx = torch.argmax(ok.to(torch.int32)).reshape(1)
    return ws.index_select(0, idx)[0], ok.index_select(0, idx)[0]


class DuplexChallenger:
    def __init__(self, capacity_seed=None):
        self.state = [0] * WIDTH
        if capacity_seed is not None:
            assert len(capacity_seed) == 4
            self.state[RATE:] = [v % gl.P for v in capacity_seed]
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger()
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self) -> None:
        assert len(self.input_buffer) <= RATE
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = poseidon2_host.permute(self.state)
        self.output_buffer = list(self.state[:RATE])

    def observe(self, value: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(value % gl.P)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_slice(self, values) -> None:
        for v in values:
            self.observe(v)

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def sample_ext(self) -> tuple:
        c0 = self.sample()
        c1 = self.sample()
        return (c0, c1)

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int, device="cuda") -> int:
        """Find the smallest witness w with ``sample_bits(bits) == 0`` after
        observing w, screening ``max(4096, 8 << bits)`` candidates per
        batched permutation on ``device``."""
        pos = len(self.input_buffer)
        base = list(self.state)
        for i, v in enumerate(self.input_buffer):
            base[i] = v
        batch = max(4096, 8 << bits)
        base_t = to_torch(np.asarray(base, dtype=np.uint64), device)
        start = 0
        while True:
            witness, found = _grind_batch(pos, bits, batch, base_t, start)
            if bool(found):
                witness = int(witness)
                ok = self.check_witness(bits, witness)
                assert ok, "batched grind disagrees with the host challenger"
                return witness
            start += batch

    def finalize(self) -> list:
        """Binding digest: one unconditional state transition, then the first
        4 state elements."""
        self._duplexing()
        return list(self.state[:4])


class ProverChannel:
    """Records the transcript while driving the challenger (sent vs hint)."""

    def __init__(self, challenger: DuplexChallenger):
        self.challenger = challenger
        self.fields: list[int] = []
        self.commitments: list[tuple] = []

    # --- sends (recorded + observed) ---
    def send_field_slice(self, values) -> None:
        vals = [int(v) % gl.P for v in values]
        self.fields.extend(vals)
        self.challenger.observe_slice(vals)

    def send_field(self, v) -> None:
        self.send_field_slice([v])

    def send_ext(self, v) -> None:
        self.send_field_slice([v[0], v[1]])

    def send_ext_slice(self, values) -> None:
        flat = []
        for v in values:
            flat.extend((v[0], v[1]))
        self.send_field_slice(flat)

    def send_commitment(self, digest) -> None:
        digest = tuple(int(v) for v in digest)
        assert len(digest) == 4
        assert all(0 <= v < gl.P for v in digest), "non-canonical digest observed"
        self.commitments.append(digest)
        self.challenger.observe_slice(digest)

    # --- hints (recorded only) ---
    def hint_field_slice(self, values) -> None:
        self.fields.extend(int(v) % gl.P for v in values)

    def hint_commitment(self, digest) -> None:
        self.commitments.append(tuple(int(v) for v in digest))

    # --- challenges ---
    def sample(self) -> int:
        return self.challenger.sample()

    def sample_bits(self, bits: int) -> int:
        return self.challenger.sample_bits(bits)

    def sample_ext(self) -> tuple:
        return self.challenger.sample_ext()

    def grind(self, bits: int, device="cuda") -> int:
        witness = self.challenger.grind(bits, device)
        self.fields.append(witness)
        return witness

    def finalize(self):
        digest = self.challenger.finalize()
        return digest, TranscriptData(self.fields, self.commitments)


class TranscriptData:
    """Raw proof payload: the field stream + commitment stream."""

    def __init__(self, fields, commitments):
        self.fields = list(fields)
        self.commitments = [tuple(c) for c in commitments]

    def size_in_bytes(self) -> int:
        return 8 * (len(self.fields) + 4 * len(self.commitments))

    def to_arrays(self):
        return (
            np.asarray(self.fields, dtype=np.uint64),
            np.asarray(self.commitments, dtype=np.uint64).reshape(-1, 4),
        )

    @classmethod
    def from_arrays(cls, fields, commitments):
        return cls(
            [int(v) for v in fields],
            [tuple(int(x) for x in c) for c in commitments],
        )


class TranscriptError(ValueError):
    pass


class VerifierChannel:
    """Replays a recorded transcript, enforcing stream discipline."""

    def __init__(self, data: TranscriptData, challenger: DuplexChallenger):
        self.data = data
        self.challenger = challenger
        self._f = 0
        self._c = 0

    def _next_fields(self, n: int) -> list:
        if self._f + n > len(self.data.fields):
            raise TranscriptError("transcript field stream exhausted")
        out = self.data.fields[self._f : self._f + n]
        self._f += n
        for v in out:
            if not (0 <= v < gl.P):
                raise TranscriptError("non-canonical field element in transcript")
        return out

    # --- sent values: read + observe ---
    def read_field_slice(self, n: int) -> list:
        vals = self._next_fields(n)
        self.challenger.observe_slice(vals)
        return vals

    def read_field(self) -> int:
        return self.read_field_slice(1)[0]

    def read_ext(self) -> tuple:
        v = self.read_field_slice(2)
        return (v[0], v[1])

    def read_ext_slice(self, n: int) -> list:
        v = self.read_field_slice(2 * n)
        return [(v[2 * i], v[2 * i + 1]) for i in range(n)]

    def read_commitment(self) -> tuple:
        if self._c >= len(self.data.commitments):
            raise TranscriptError("transcript commitment stream exhausted")
        digest = self.data.commitments[self._c]
        self._c += 1
        self.challenger.observe_slice(digest)
        return digest

    # --- hints: read only ---
    def read_hint_fields(self, n: int) -> list:
        return self._next_fields(n)

    def read_hint_commitment(self) -> tuple:
        if self._c >= len(self.data.commitments):
            raise TranscriptError("transcript commitment stream exhausted")
        digest = self.data.commitments[self._c]
        self._c += 1
        return digest

    # --- challenges ---
    def sample(self) -> int:
        return self.challenger.sample()

    def sample_bits(self, bits: int) -> int:
        return self.challenger.sample_bits(bits)

    def sample_ext(self) -> tuple:
        return self.challenger.sample_ext()

    def check_pow(self, bits: int) -> None:
        witness = self._next_fields(1)[0]
        if not self.challenger.check_witness(bits, witness):
            raise TranscriptError(f"proof-of-work check failed ({bits} bits)")

    def finalize(self):
        if self._f != len(self.data.fields) or self._c != len(self.data.commitments):
            raise TranscriptError("trailing data in transcript")
        return self.challenger.finalize()
