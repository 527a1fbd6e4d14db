"""Authenticated encryption.

``AeadPoseidon2`` — arithmetization-oriented AEAD per the MonkeySpongeWrap
construction (eprint 2023/1668) over the Poseidon2 permutation, exactly
mirroring aead/aead_poseidon2/mod.rs: key and nonce fill the two rate
halves, associated data is duplex-overwritten (capacity[0] += 1 each block),
plaintext blocks are encrypted by duplex-add keystream, tag = first rate
word after a final permutation. Elements and 7-byte-packed byte payloads.

``XChaCha20Poly1305`` — RFC 8439 ChaCha20-Poly1305 with the HChaCha20
nonce extension (draft-irtf-cfrg-xchacha), for the byte-oriented IES
schemes (aead/xchacha).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..field import gl
from ..hash import poseidon2_host as hp

RATE = 8
P = gl.P


class AeadError(ValueError):
    pass


# ---------------------------------------------------------------------------
# byte <-> element packing (crates/crypto/src/utils/mod.rs:97,150)
# ---------------------------------------------------------------------------


def bytes_to_elements_with_padding(data: bytes) -> list[int]:
    """7-byte chunks, little-endian; last chunk gets a 0x01 marker byte."""
    if not data:
        return []
    out = []
    n_chunks = (len(data) + 6) // 7
    for i in range(n_chunks):
        chunk = data[7 * i : 7 * i + 7]
        buf = bytearray(8)
        buf[: len(chunk)] = chunk
        if i == n_chunks - 1:
            buf[len(chunk)] = 1
        out.append(int.from_bytes(bytes(buf), "little"))
    return out


def padded_elements_to_bytes(felts: list[int]) -> bytes:
    if not felts:
        return b""
    out = bytearray()
    for v in felts[:-1]:
        out += int(v).to_bytes(8, "little")[:7]
    last = int(felts[-1]).to_bytes(8, "little")
    pos = last.rfind(b"\x01")
    if pos < 0:
        raise AeadError("malformed byte padding")
    out += last[:pos]
    return bytes(out)


# ---------------------------------------------------------------------------
# AeadPoseidon2
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EncryptedData:
    data_type: str  # "elements" | "bytes"
    ciphertext: list[int]
    auth_tag: tuple  # 4 felts
    nonce: tuple  # 4 felts


def _pad(data: list[int]) -> list[int]:
    rem = len(data) % RATE
    return list(data) + [1] + [0] * (RATE - rem - 1)


def _unpad(plain: list[int]) -> list[int]:
    assert len(plain) % RATE == 0
    final = plain[-RATE:]
    pos = None
    for i in reversed(range(RATE)):
        if final[i] == 1:
            pos = i
            break
    if pos is None:
        raise AeadError("malformed padding")
    return plain[: len(plain) - RATE + pos]


class _Sponge:
    def __init__(self, key, nonce):
        self.state = [*(v % P for v in key), *(v % P for v in nonce), 0, 0, 0, 0]

    def duplex_overwrite(self, block):
        self.state = hp.permute(self.state)
        self.state[8] = (self.state[8] + 1) % P
        self.state[:RATE] = [v % P for v in block]

    def duplex_add(self, block):
        self.state = hp.permute(self.state)
        keystream = list(self.state[:RATE])
        for i, v in enumerate(block):
            self.state[i] = (self.state[i] + v) % P
        return keystream

    def squeeze_tag(self):
        self.state = hp.permute(self.state)
        return tuple(self.state[:4])


class AeadPoseidon2:
    """Secret key = 4 felts; nonce = 4 felts; tag = 4 felts."""

    KEY_SIZE_BYTES = 32

    def __init__(self, key):
        assert len(key) == 4
        self.key = tuple(v % P for v in key)

    @classmethod
    def key_from_uniform_bytes(cls, data: bytes) -> "AeadPoseidon2":
        """Reduce 8-byte LE chunks mod p (uniform-ish keying from KDF out)."""
        assert len(data) >= 32
        return cls([int.from_bytes(data[8 * i : 8 * i + 8], "little") % P for i in range(4)])

    def encrypt_elements(self, data, associated_data=(), nonce=None) -> EncryptedData:
        if nonce is None:
            import secrets

            nonce = tuple(secrets.randbelow(P) for _ in range(4))
        sponge = _Sponge(self.key, nonce)
        padded_ad = _pad([v % P for v in associated_data])
        for i in range(0, len(padded_ad), RATE):
            sponge.duplex_overwrite(padded_ad[i : i + RATE])
        ct = []
        padded = _pad([v % P for v in data])
        for i in range(0, len(padded), RATE):
            block = padded[i : i + RATE]
            ks = sponge.duplex_add(block)
            ct.extend((v + k) % P for v, k in zip(block, ks))
        tag = sponge.squeeze_tag()
        return EncryptedData("elements", ct, tag, tuple(nonce))

    def decrypt_elements(self, enc: EncryptedData, associated_data=()) -> list[int]:
        if len(enc.ciphertext) % RATE:
            raise AeadError("ciphertext length not multiple of rate")
        sponge = _Sponge(self.key, enc.nonce)
        padded_ad = _pad([v % P for v in associated_data])
        for i in range(0, len(padded_ad), RATE):
            sponge.duplex_overwrite(padded_ad[i : i + RATE])
        plain = []
        for i in range(0, len(enc.ciphertext), RATE):
            block = [v % P for v in enc.ciphertext[i : i + RATE]]
            ks = sponge.duplex_add([])
            plain.extend((c - k) % P for c, k in zip(block, ks))
            sponge.state[:RATE] = block
        tag = sponge.squeeze_tag()
        if tag != tuple(v % P for v in enc.auth_tag):
            raise AeadError("invalid authentication tag")
        return _unpad(plain)

    def encrypt_bytes(self, data: bytes, associated_data: bytes = b"", nonce=None) -> EncryptedData:
        enc = self.encrypt_elements(
            bytes_to_elements_with_padding(data),
            bytes_to_elements_with_padding(associated_data),
            nonce,
        )
        return EncryptedData("bytes", enc.ciphertext, enc.auth_tag, enc.nonce)

    def decrypt_bytes(self, enc: EncryptedData, associated_data: bytes = b"") -> bytes:
        if enc.data_type != "bytes":
            raise AeadError("data was not encrypted as bytes")
        felts = self.decrypt_elements(
            EncryptedData("elements", enc.ciphertext, enc.auth_tag, enc.nonce),
            bytes_to_elements_with_padding(associated_data),
        )
        return padded_elements_to_bytes(felts)


# ---------------------------------------------------------------------------
# XChaCha20-Poly1305 (RFC 8439 + HChaCha20)
# ---------------------------------------------------------------------------


def _rotl32(v, c):
    return ((v << c) | (v >> (32 - c))) & 0xFFFFFFFF


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl32(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl32(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & 0xFFFFFFFF
    s[d] = _rotl32(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & 0xFFFFFFFF
    s[b] = _rotl32(s[b] ^ s[c], 7)


_SIGMA = struct.unpack("<4I", b"expand 32-byte k")


def _chacha_rounds(state: list[int]) -> list[int]:
    s = list(state)
    for _ in range(10):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return s


def _chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    state = [*_SIGMA, *struct.unpack("<8I", key), counter, *struct.unpack("<3I", nonce)]
    out = _chacha_rounds(state)
    return struct.pack("<16I", *((a + b) & 0xFFFFFFFF for a, b in zip(out, state)))


def _chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 64):
        ks = _chacha20_block(key, counter + i // 64, nonce)
        chunk = data[i : i + 64]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)


def _hchacha20(key: bytes, nonce16: bytes) -> bytes:
    state = [*_SIGMA, *struct.unpack("<8I", key), *struct.unpack("<4I", nonce16)]
    s = _chacha_rounds(state)
    return struct.pack("<4I", *s[0:4]) + struct.pack("<4I", *s[12:16])


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i : i + 16]
        n = int.from_bytes(chunk + b"\x01", "little")
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


class XChaCha20Poly1305:
    KEY_SIZE_BYTES = 32
    NONCE_SIZE = 24

    def __init__(self, key: bytes):
        assert len(key) == 32
        self.key = key

    @classmethod
    def key_from_uniform_bytes(cls, data: bytes) -> "XChaCha20Poly1305":
        return cls(data[:32])

    def _subkey_nonce(self, nonce24: bytes):
        subkey = _hchacha20(self.key, nonce24[:16])
        return subkey, b"\x00" * 4 + nonce24[16:]

    def encrypt_bytes(self, data: bytes, associated_data: bytes = b"", nonce: bytes | None = None) -> bytes:
        if nonce is None:
            import secrets

            nonce = secrets.token_bytes(24)
        subkey, n12 = self._subkey_nonce(nonce)
        ct = _chacha20_xor(subkey, 1, n12, data)
        otk = _chacha20_block(subkey, 0, n12)[:32]
        mac_data = (
            associated_data + b"\x00" * (-len(associated_data) % 16)
            + ct + b"\x00" * (-len(ct) % 16)
            + struct.pack("<QQ", len(associated_data), len(ct))
        )
        tag = _poly1305(otk, mac_data)
        return nonce + ct + tag

    def decrypt_bytes(self, sealed: bytes, associated_data: bytes = b"") -> bytes:
        if len(sealed) < 40:
            raise AeadError("ciphertext too short")
        nonce, ct, tag = sealed[:24], sealed[24:-16], sealed[-16:]
        subkey, n12 = self._subkey_nonce(nonce)
        otk = _chacha20_block(subkey, 0, n12)[:32]
        mac_data = (
            associated_data + b"\x00" * (-len(associated_data) % 16)
            + ct + b"\x00" * (-len(ct) % 16)
            + struct.pack("<QQ", len(associated_data), len(ct))
        )
        import hmac as _hmac

        if not _hmac.compare_digest(_poly1305(otk, mac_data), tag):
            raise AeadError("invalid authentication tag")
        return _chacha20_xor(subkey, 1, n12, ct)
