"""Precompile VM (deferred prover): the second STARK.

Reference analog: precompiles-prover/ — ``prove_deferred_state``
(precompiles-prover/src/lib.rs:35) proves the deferred claims a main-VM
execution logged via LOGDEFERRED, and ``verify_deferred`` checks that
proof against the deferred root bound into the main proof's public claim.
"""

from .ec import EcAddClaim, EcMulClaim
from .keccak import Keccak256Claim
from .keccak_var import KeccakClaim
from .session import (
    DEFERRED_EMPTY_ROOT,
    U256AddClaim,
    U256MulClaim,
    claim_statement_digest,
    deferred_root_for,
    prove_deferred_state,
    verify_deferred,
)

__all__ = [
    "DEFERRED_EMPTY_ROOT",
    "EcAddClaim",
    "EcMulClaim",
    "Keccak256Claim",
    "KeccakClaim",
    "U256AddClaim",
    "U256MulClaim",
    "claim_statement_digest",
    "deferred_root_for",
    "prove_deferred_state",
    "verify_deferred",
]
