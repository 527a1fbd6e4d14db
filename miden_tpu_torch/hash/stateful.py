"""Stateful sponge-like hashers (incremental absorb / squeeze).

Python surface of the reference `stateful-hasher` crate
(crates/stateful-hasher/src/lib.rs:45 — StatefulHasher / StatefulSponge /
SerializingStatefulSponge / ChainingHasher / TruncatingHasher +
Alignable): an evolving state that commitment schemes and Merkle
builders use to absorb rows incrementally and squeeze digests. The LMCS
streaming leaf absorption (merkle/lmcs.py) implements the same
overwrite-mode semantics vectorized on-device; this module is the
host-side, object-level API.

Alignment semantics (Alignable::ALIGNMENT): the maximum number of
virtual zero elements padding may add — `rate` for overwrite-mode field
sponges, 1 (none) for chaining hashers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..field import gl
from . import poseidon2_host as hp


class StatefulHasher:
    """Interface: absorb_into(state, items), squeeze(state), hash_rows.

    Subclasses define `new_state()`, `absorb_into`, and `squeeze`; this
    base provides the one-shot `hash_rows` composition exactly like the
    trait's default method (stateful-hasher/src/lib.rs:57-69)."""

    alignment: int = 1

    def new_state(self):
        raise NotImplementedError

    def absorb_into(self, state, items) -> None:
        raise NotImplementedError

    def squeeze(self, state):
        raise NotImplementedError

    def hash_rows(self, rows):
        state = self.new_state()
        for row in rows:
            self.absorb_into(state, row)
        return self.squeeze(state)


@dataclass
class _SpongeState:
    state: list = field(default_factory=lambda: [0] * 12)


class StatefulSponge(StatefulHasher):
    """Overwrite-mode field sponge over a width-12/rate-8 permutation
    (field_sponge.rs `StatefulSponge<P, 12, 8, 4>`): each absorbed chunk
    overwrites the rate, zero-padding the trailing partial chunk, then
    permutes; digest = state[0:4]."""

    rate = 8
    digest_size = 4
    alignment = 8

    def __init__(self, permutation=hp.permute):
        self._permute = permutation

    def new_state(self) -> _SpongeState:
        return _SpongeState()

    def absorb_into(self, state: _SpongeState, items) -> None:
        items = [int(v) % gl.P for v in items]
        for off in range(0, len(items), self.rate):
            chunk = items[off : off + self.rate]
            for i in range(self.rate):
                state.state[i] = chunk[i] if i < len(chunk) else 0
            state.state[:] = self._permute(state.state)

    def squeeze(self, state: _SpongeState) -> tuple:
        return tuple(state.state[: self.digest_size])


class SerializingStatefulSponge(StatefulHasher):
    """Serializes field elements to little-endian u64 bytes before
    absorbing into a byte hasher (serializing_sponge.rs) — the leaf
    hasher shape for byte-hash (blake3/keccak) LMCS trees."""

    alignment = 1

    def __init__(self, hasher_factory):
        """hasher_factory() -> object with .update(bytes)/.digest()."""
        self._factory = hasher_factory

    def new_state(self):
        return self._factory()

    def absorb_into(self, state, items) -> None:
        for v in items:
            state.update((int(v) % gl.P).to_bytes(8, "little"))

    def squeeze(self, state):
        return state.digest()


class ChainingHasher(StatefulHasher):
    """Chaining mode `state' = H(state || input)` over a one-shot hash
    function (chaining.rs); ALIGNMENT = 1 (no padding)."""

    alignment = 1

    def __init__(self, hash_fn, empty_state=b""):
        """hash_fn(bytes) -> bytes digest; state is the running digest."""
        self._hash = hash_fn
        self._empty = empty_state

    def new_state(self):
        return [self._empty]

    def absorb_into(self, state, items) -> None:
        data = b"".join(
            (int(v) % gl.P).to_bytes(8, "little") for v in items
        )
        state[0] = self._hash(bytes(state[0]) + data)

    def squeeze(self, state):
        return state[0]


class TruncatingHasher(StatefulHasher):
    """Wraps a hasher, truncating squeezed digests to a fixed prefix
    (truncating.rs) — e.g. 192-bit commitments from 256-bit hashes."""

    def __init__(self, inner: StatefulHasher, length: int):
        self.inner = inner
        self.length = length
        self.alignment = inner.alignment

    def new_state(self):
        return self.inner.new_state()

    def absorb_into(self, state, items) -> None:
        self.inner.absorb_into(state, items)

    def squeeze(self, state):
        return self.inner.squeeze(state)[: self.length]
