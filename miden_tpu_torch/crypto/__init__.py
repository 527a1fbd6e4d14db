"""Host-side crypto utilities (SURVEY.md §2.1, crates/crypto/src/{rand,
aead,ecdh,ies}).

- ``rand_coin`` — Poseidon2 SPONGE_PRG reseedable RNG (rand/coin.rs)
- ``aead`` — arithmetization-oriented AEAD over Poseidon2
  (MonkeySpongeWrap, aead/aead_poseidon2/) + XChaCha20-Poly1305
- ``ecdh`` — secp256k1 and X25519 Diffie-Hellman with HKDF-SHA256
  key-material extraction (ecdh/)
- ``ies`` — sealed boxes: ECDH + AEAD (ies/)
"""

from . import aead, ecdh, ies, rand_coin  # noqa: F401
