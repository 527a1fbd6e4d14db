"""Fiat-Shamir duplex challenger and the verifier's transcript channel.

The p3 ``DuplexChallenger<Felt, Poseidon2, 12, 8>`` state machine in exact
Python ints, and :class:`VerifierChannel`, which replays a recorded
transcript and enforces an empty tail. A copy of the host half of the
port's ``transcript/challenger.py`` (its batched grinding on the device is
the prover's, not copied).

Duplex semantics (p3): observe buffers into ``input_buffer`` and duplexes at
rate 8; duplexing overwrites ``state[0..len(buffer)]``, permutes and refills
``output_buffer = state[0..8]``; ``sample`` pops from the end of the output
buffer; any observe invalidates buffered output.
"""

from __future__ import annotations

import numpy as np

from . import gl
from . import poseidon2 as poseidon2_host

RATE = 8
WIDTH = 12


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

    def finalize(self) -> list:
        """Binding digest: one unconditional state transition, then the first
        4 state elements."""
        self._duplexing()
        return list(self.state[:4])


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
