"""Digital signature schemes (host side).

Host crypto: signatures are made and checked by the host and enter the
proving path only as advice data, so these are exact scalar
implementations, not device code:

- ``ecdsa_k256`` — ECDSA over secp256k1 with Keccak-256 message hashing
  (the reference's dsa/ecdsa_k256_keccak/mod.rs); the VM verifies it in
  MASM (``stdlib`` ``crypto::dsa::ecdsa_secp256k1``) through deferred EC
  claims;
- ``ed25519`` — EdDSA over Curve25519 per RFC 8032, SHA-512
  (dsa/eddsa_25519_sha512/mod.rs);
- ``falcon512`` — Falcon-512 lattice signatures with Poseidon2
  hash-to-point (dsa/falcon512_poseidon2/).
"""

from . import ecdsa_k256, ed25519, falcon512  # noqa: F401
