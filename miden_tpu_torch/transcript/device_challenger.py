"""Device-resident Fiat-Shamir challenger + recording channel.

The sponge state is a (12,) int64 tensor on the prover's device; every
observe / duplex / sample / grind is a device op (the single-state
permutation :func:`_permute1` is a kernel K3 launch on the card), so the
proof pipeline runs without host round-trips until
:meth:`DeviceProverChannel.materialize` reads everything back at once.

Control flow depends only on the counts of observed and sampled elements,
fixed by the statement shape. Semantics are those of the host
:class:`~miden_tpu_torch.transcript.challenger.DuplexChallenger`, value for
value (p3 ``DuplexChallenger<Felt, Poseidon2, 12, 8>``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gl
from ..field.goldilocks import to_numpy, to_torch
from ..hash import poseidon2
from .challenger import TranscriptData, _grind_batch

RATE = 8
WIDTH = 12

#: candidates screened per batched permutation when grinding on the CPU,
#: which stops at the first batch holding a witness
_CPU_GRIND_CHUNK = 4096


def _permute1(state: torch.Tensor) -> torch.Tensor:
    """Permute a single (12,) state."""
    return poseidon2.permute(state[:, None])[:, 0]


def _grind_smallest(pos: int, bits: int, batch: int, base: torch.Tensor):
    """The smallest passing witness in ``[0, batch)`` as ``(witness, ok)``.
    On the card one batched permutation screens all candidates (no host
    sync); on the CPU the same range is screened in chunks that stop at the
    first hit, which gives the same witness."""
    if base.is_cuda:
        return _grind_batch(pos, bits, batch, base, 0)
    for start in range(0, batch, _CPU_GRIND_CHUNK):
        witness, ok = _grind_batch(pos, bits, min(_CPU_GRIND_CHUNK, batch - start), base, start)
        if bool(ok):
            return witness, ok
    zero = torch.zeros((), dtype=torch.int64, device=base.device)
    return zero, zero != 0


class DeviceChallenger:
    """Duplex challenger over device scalars (static control flow)."""

    def __init__(self, state: torch.Tensor, ibuf: torch.Tensor | None = None):
        assert tuple(state.shape) == (WIDTH,)
        self.state = state
        self.device = state.device
        # input buffer: (k,) with 0 <= k < RATE
        self.ibuf = ibuf if ibuf is not None else state[:0]
        # output buffer: state[:8] after the last duplex; obuf_n entries
        # remain (popped from the end)
        self.obuf = None
        self.obuf_n = 0

    @classmethod
    def from_host(cls, host, device="cuda") -> "DeviceChallenger":
        c = cls(to_torch(np.asarray(host.state, dtype=np.uint64), device))
        if host.input_buffer:
            c.ibuf = to_torch(np.asarray(host.input_buffer, dtype=np.uint64), device)
        if host.output_buffer:
            c.obuf = c.state[:RATE]
            c.obuf_n = len(host.output_buffer)
        return c

    def _scalars(self, values) -> torch.Tensor:
        vals = [int(v) % gl.P for v in values]
        return to_torch(np.asarray(vals, dtype=np.uint64), self.device)

    # -- core sponge ---------------------------------------------------------
    def _duplex_partial(self) -> None:
        """Duplex with the (possibly partial) input buffer."""
        k = self.ibuf.shape[0]
        assert k <= RATE
        s = torch.cat([self.ibuf, self.state[k:]]) if k else self.state
        self.state = _permute1(s)
        self.ibuf = self.state[:0]
        self.obuf = self.state[:RATE]
        self.obuf_n = RATE

    def observe_arr(self, arr: torch.Tensor) -> None:
        """Observe a flat device array of any length."""
        assert arr.ndim == 1
        if arr.shape[0] == 0:
            # the host challenger's observe_slice([]) keeps its output buffer
            return
        self.obuf_n = 0
        total = torch.cat([self.ibuf, arr]) if self.ibuf.shape[0] else arr
        full = total.shape[0] // RATE
        for c in range(full):
            self.state = _permute1(torch.cat([total[RATE * c : RATE * (c + 1)], self.state[RATE:]]))
        self.ibuf = total[full * RATE :]
        if full and self.ibuf.shape[0] == 0:
            self.obuf = self.state[:RATE]
            self.obuf_n = RATE

    def observe(self, v) -> None:
        if isinstance(v, torch.Tensor):
            self.observe_arr(v.reshape(1))
        else:
            self.observe_arr(self._scalars([v]))

    def observe_slice(self, values) -> None:
        if isinstance(values, torch.Tensor):
            self.observe_arr(values.reshape(-1))
        elif len(values):
            self.observe_arr(self._scalars(values))

    def sample(self) -> torch.Tensor:
        if self.ibuf.shape[0] or self.obuf_n == 0:
            self._duplex_partial()
        self.obuf_n -= 1
        return self.obuf[self.obuf_n]

    def sample_ext(self) -> torch.Tensor:
        c0 = self.sample()
        c1 = self.sample()
        return torch.stack([c0, c1])

    # -- proof of work -------------------------------------------------------
    def grind(self, bits: int):
        """Find the smallest witness w < batch such that observing w then
        sampling gives ``bits`` low zero bits. Returns ``(witness, ok)`` 0-d
        tensors; ``ok`` is checked at the final readback."""
        k = self.ibuf.shape[0]
        base = torch.cat([self.ibuf, self.state[k:]]) if k else self.state
        batch = min(1 << 21, max(4096, 32 << bits))
        witness, ok = _grind_smallest(k, bits, batch, base)
        self.observe(witness)
        self.sample()  # pop the checked lane
        return witness, ok

    def finalize(self) -> torch.Tensor:
        """Binding digest: one unconditional transition, first 4 lanes."""
        self._duplex_partial()
        return self.state[:4]


def transcript_payload(entries: list, digest: torch.Tensor, extra, checks: list) -> torch.Tensor:
    """The flat device tensor a proof reads back at once: every recorded
    entry in transcript order, the digest, ``extra`` (or nothing) and one
    0 / 1 per registered check."""
    parts = [arr for (_k, arr) in entries] + [digest]
    if extra is not None:
        parts.append(extra)
    parts += [flag.to(torch.int64) for (_l, flag) in checks]
    return torch.cat([p.reshape(-1) for p in parts])


class DeviceProverChannel:
    """Transcript recorder over device values; ``materialize()`` performs the
    single blocking readback into host :class:`TranscriptData` streams."""

    def __init__(self, challenger: DeviceChallenger):
        self.challenger = challenger
        self._entries: list = []  # ("f" | "c", flat device tensor)
        self._checks: list = []  # (label, device bool) asserted at readback
        self._host_fields: list | None = None
        self._host_commitments: list | None = None
        self._digest: list | None = None

    def _as_tensor(self, values) -> torch.Tensor:
        if isinstance(values, torch.Tensor):
            return values.reshape(-1)
        return self.challenger._scalars(values)

    # --- sends (recorded + observed) ---
    def send_field_slice(self, values) -> None:
        arr = self._as_tensor(values)
        self._entries.append(("f", arr))
        self.challenger.observe_arr(arr)

    def send_ext_slice(self, values: torch.Tensor) -> None:
        """(k, 2) extension elements, sent interleaved [c0, c1, c0, ...]."""
        self.send_field_slice(values.reshape(-1))

    def send_commitment(self, digest: torch.Tensor) -> None:
        assert tuple(digest.shape) == (4,)
        self._entries.append(("c", digest))
        self.challenger.observe_arr(digest)

    # --- hints (recorded only; host values after materialize()) ---
    def hint_field_slice(self, values) -> None:
        if self._host_fields is not None:
            self._host_fields.extend(int(v) % gl.P for v in values)
            return
        self._entries.append(("f", self._as_tensor(values)))

    def hint_commitment(self, digest) -> None:
        if self._host_commitments is not None:
            self._host_commitments.append(tuple(int(v) for v in digest))
            return
        if not isinstance(digest, torch.Tensor):
            digest = to_torch(np.asarray(digest, dtype=np.uint64), self.challenger.device)
        self._entries.append(("c", digest))

    # --- challenges ---
    def sample(self) -> torch.Tensor:
        return self.challenger.sample()

    def sample_ext(self) -> torch.Tensor:
        return self.challenger.sample_ext()

    def grind(self, bits: int) -> None:
        witness, ok = self.challenger.grind(bits)
        self._entries.append(("f", witness.reshape(1)))
        self._checks.append((f"grind({bits})", ok))

    def check(self, label: str, flag) -> None:
        """Register a device boolean to assert at readback."""
        self._checks.append((label, flag))

    # --- the single readback ---
    def materialize(self, extra: torch.Tensor | None = None):
        """Read everything back in ONE transfer; later hints append to the
        host streams. Returns ``extra`` as numpy u64 (or None). Raises if a
        registered device check failed."""
        digest = self.challenger.finalize()
        host = to_numpy(transcript_payload(self._entries, digest, extra, self._checks))  # THE readback
        vals = self.read_back(host, 0 if extra is None else extra.numel())
        return None if extra is None else vals

    def read_back(self, host: np.ndarray, n_extra: int = 0):
        """Take the read-back :func:`transcript_payload` of this channel's
        entries and checks into the host streams; returns the ``n_extra``
        values of ``extra``. Raises if a registered device check failed."""
        off = 0
        fields: list[int] = []
        commitments: list[tuple] = []
        for kind, arr in self._entries:
            n = arr.numel()
            vals = host[off : off + n]
            off += n
            if kind == "f":
                fields.extend(int(v) for v in vals)
            else:
                commitments.append(tuple(int(v) for v in vals))
        digest_vals = [int(v) for v in host[off : off + 4]]
        off += 4
        extra_vals = host[off : off + n_extra]
        off += n_extra
        assert len(host) - off == len(self._checks)
        for (label, _), v in zip(self._checks, host[off:]):
            if not int(v):
                raise AssertionError(f"device-side check failed: {label}")
        self._host_fields = fields
        self._host_commitments = commitments
        self._digest = digest_vals
        return extra_vals

    def finalize(self):
        """Final (digest, TranscriptData) after materialize() + hint tail."""
        assert self._host_fields is not None, "materialize() first"
        return self._digest, TranscriptData(self._host_fields, self._host_commitments)
