"""SHA-256 (host, via hashlib — byte-oriented, used off the proving path).

Behavioral spec: crates/crypto/src/hash/sha2/ (wraps the `sha2` crate):
``hash`` over raw bytes, ``hash_elements`` over LE bytes of canonical u64
felts, ``merge`` over concatenated digests.
"""

from __future__ import annotations

import hashlib
import struct


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def hash_elements(elements: list[int]) -> bytes:
    return sha256(b"".join(struct.pack("<Q", e) for e in elements))


def merge(left: bytes, right: bytes) -> bytes:
    return sha256(left + right)
