"""Digital signature schemes (host side).

``ecdsa_k256`` — ECDSA over secp256k1 with Keccak-256 message hashing
(the reference's dsa/ecdsa_k256_keccak/mod.rs). Signatures enter the
proving path only as advice data: the VM verifies them in MASM
(``stdlib`` ``crypto::dsa::ecdsa_secp256k1``) through deferred EC claims.
"""

from . import ecdsa_k256  # noqa: F401
