"""PCS / protocol parameters.

Mirrors ``PcsParams`` (reference crates/lifted-stark/src/pcs/params.rs:63-100)
and the Miden production constants (air/src/config.rs:54-67).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PcsParams:
    log_blowup: int = 3
    log_folding_arity: int = 2
    log_final_poly_degree: int = 7
    folding_pow_bits: int = 4
    deep_pow_bits: int = 12
    num_queries: int = 27
    query_pow_bits: int = 16
    #: LMCS commitment hash (reference ships one StarkConfig per hash,
    #: air/src/config.rs:236-353). The full pipeline requires an algebraic
    #: hash (canonical-felt digests in the transcript): poseidon2 / rpo256 /
    #: rpx256.
    hash_name: str = "poseidon2"

    def __post_init__(self):
        assert 1 <= self.log_blowup <= 31
        assert self.log_folding_arity in (1, 2, 3)
        assert self.num_queries > 0
        assert self.hash_name in ("poseidon2", "rpo256", "rpx256")

    def lmcs_hash(self):
        from .lmcs import HASH_CONFIGS

        return HASH_CONFIGS[self.hash_name]()

    @property
    def blowup(self) -> int:
        return 1 << self.log_blowup

    @property
    def arity(self) -> int:
        return 1 << self.log_folding_arity

    @property
    def final_poly_degree(self) -> int:
        return 1 << self.log_final_poly_degree


#: The Miden VM production profile (96-bit security with the PoW terms).
MIDEN_PARAMS = PcsParams()

#: Small, fast profile for tests (NOT secure — mirrors the reference's
#: insecure test configs, e.g. precompiles-prover stark_config.rs:122-129).
TEST_PARAMS = PcsParams(
    log_blowup=3,
    log_folding_arity=2,
    log_final_poly_degree=2,
    folding_pow_bits=1,
    deep_pow_bits=2,
    num_queries=4,
    query_pow_bits=2,
)
