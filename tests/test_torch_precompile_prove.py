"""Session proofs of the port on the CPU (slow): bytes and verdicts.

``U256_SESSION`` (``miden_tpu_torch.bench_session``) is proved by the port
and by ``miden_tpu`` at ``TEST_PARAMS``: the ``MTPU`` bytes are equal, their
SHA-256 is the pinned one that the card's proof is held to
(``chip_smoke.py``), and each package's verifier accepts the other's proof.
The main-proof-binds-session loop of ``miden_tpu``'s
``tests/test_precompile.py:115-143`` then runs on the port: a MASM program
logs the session's statement digests, and its VM proof verifies only with
the session proof.

A session holding every AIR is not proved here: its keccak AIRs' 5108
columns are lifted to the range table's 2^20-row LDE, about 8·10^8 Poseidon2
permutations, hours for the port's plain permutation on a CPU. Its card proof
is held in ``test_torch_precompile_card.py``.
"""

import pytest

from miden_tpu_torch import bench_session as BS
from miden_tpu_torch.precompile import session as S
from miden_tpu_torch.stark.params import TEST_PARAMS
from miden_tpu_torch.stark.proof_io import proof_from_bytes, proof_to_bytes
from miden_tpu_torch.stark.verifier import VerificationError

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def u256_session():
    return S.prove_deferred_state(BS.claims(BS.U256_SESSION), TEST_PARAMS, device="cpu")


def _reference_claims(spec):
    from miden_tpu.precompile.session import U256AddClaim, U256MulClaim

    cls = {"u256_add": U256AddClaim, "u256_mul": U256MulClaim}
    return [cls[kind](a=a, b=b) for kind, a, b in spec]


def test_u256_session_bytes_equal_miden_tpu_and_pinned(u256_session):
    from miden_tpu.precompile.session import DeferredProof as JDeferredProof
    from miden_tpu.precompile.session import prove_deferred_state as j_prove
    from miden_tpu.precompile.session import verify_deferred as j_verify
    from miden_tpu.stark.proof_io import proof_from_bytes as j_from_bytes
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.stark.proof_io import proof_to_bytes as j_to_bytes

    ref = j_prove(_reference_claims(BS.U256_SESSION), params=J_TEST_PARAMS)
    blob = proof_to_bytes(u256_session.stark)
    assert blob == j_to_bytes(ref.stark)
    assert tuple(u256_session.root) == tuple(ref.root)
    assert BS.proof_digest(u256_session) == BS.PINNED["U256_SESSION"]
    # each package's verifier accepts the other's proof after an MTPU round trip
    S.verify_deferred(
        S.DeferredProof(ref.root, ref.n_claims, proof_from_bytes(j_to_bytes(ref.stark)),
                        ref.n_u256, ref.n_kmerge, ref.n_ec),
        ref.root, TEST_PARAMS,
    )
    j_verify(
        JDeferredProof(u256_session.root, u256_session.n_claims, j_from_bytes(blob),
                       u256_session.n_u256, u256_session.n_kmerge, u256_session.n_ec),
        u256_session.root, params=J_TEST_PARAMS,
    )
    with pytest.raises(VerificationError):
        S.verify_deferred(u256_session, (1, 2, 3, 4), TEST_PARAMS)


def test_main_proof_binds_session_root(u256_session):
    """tests/test_precompile.py:115-143 on the port."""
    from miden_tpu_torch.vm.assembler import assemble
    from miden_tpu_torch.vm.prove import prove_program, verify_program

    pushes = []
    for c in BS.claims(BS.U256_SESSION):
        s = S.claim_statement_digest(c)
        # stack for log_deferred: statement digest at s[4:8]
        pushes.append(f"push.0.0.0.0 push.{s[3]}.{s[2]}.{s[1]}.{s[0]} swapw log_deferred dropw dropw dropw")
    _, proof = prove_program(assemble("begin " + " ".join(pushes) + " end"), params=TEST_PARAMS, device="cpu")
    with pytest.raises(VerificationError):
        verify_program(proof, params=TEST_PARAMS)
    verify_program(proof, params=TEST_PARAMS, partial=True)
    assert tuple(u256_session.root) == tuple(proof.deferred_root)
    verify_program(proof, params=TEST_PARAMS, deferred=u256_session)
    with pytest.raises(VerificationError):
        other = S.DeferredProof((1, 2, 3, 4), u256_session.n_claims, u256_session.stark,
                                u256_session.n_u256, u256_session.n_kmerge, u256_session.n_ec)
        verify_program(proof, params=TEST_PARAMS, deferred=other)
