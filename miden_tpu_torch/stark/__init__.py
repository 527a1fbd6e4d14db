"""Lifted STARK proving engine (PyTorch port)."""

from . import air, domains, params, pcs, preprocessed, prover, verifier  # noqa: F401
from .air import Air, Folder, MultiAir  # noqa: F401
from .params import MIDEN_PARAMS, TEST_PARAMS, PcsParams  # noqa: F401
from .preprocessed import Preprocessed, build_preprocessed  # noqa: F401
from .prover import Proof, StarkOutput, Statement, prove  # noqa: F401
from .verifier import VerificationError, verify  # noqa: F401
