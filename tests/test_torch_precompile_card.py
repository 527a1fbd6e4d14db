"""Session proofs made by the port on the card, checked by both verifiers.

``chip_smoke.py`` proves the pinned sessions of ``miden_tpu_torch.bench_session``
on the card and holds their ``MTPU`` bytes to ``bench_session.PINNED``. The
bytes of the three sessions that hold the keccak and EC AIRs are kept in
``tests/data/`` (a CPU proof of them lifts about 8·10^8 Poseidon2 permutations
through the port's plain twin, hours), and here:

- their SHA-256 is the pinned one, and the port's verifier accepts
  ``MIXED_SESSION``, which holds every session AIR;
- ``miden_tpu``'s verifier accepts the two halves of ``MIXED_SESSION`` (its
  keccak claims without EC claims, its EC claims without the arbitrary-length
  keccak claim) after an ``MTPU`` round trip. It cannot accept the whole:
  its KeccakVarAir and SpongeAir count the arbitrary-length keccak claims
  without subtracting the EC claims, so no trace of a session mixing the two
  satisfies them (``test_miden_tpu_rejects_an_ec_and_keccak_session``; the
  port's AIRs subtract n_ec).
"""

import hashlib
from pathlib import Path

import pytest

from miden_tpu_torch import bench_session as BS
from miden_tpu_torch.precompile import ec, keccak, session as S
from miden_tpu_torch.stark.params import TEST_PARAMS
from miden_tpu_torch.stark.proof_io import proof_from_bytes

DATA = Path(__file__).parent / "data"
CARD_SESSIONS = ["MIXED_SESSION", "MIXED_SESSION_KECCAK", "MIXED_SESSION_EC"]


def _session(name):
    """(root, claim counts, MTPU bytes) of a card-made session proof."""
    claims = BS.claims(getattr(BS, name))
    counts = (
        len(claims),
        sum(isinstance(c, (S.U256AddClaim, S.U256MulClaim)) for c in claims),
        sum(isinstance(c, keccak.Keccak256Claim) for c in claims),
        sum(isinstance(c, (ec.EcAddClaim, ec.EcMulClaim)) for c in claims),
    )
    return S.deferred_root_for(claims), counts, (DATA / f"{name.lower()}.mtpu").read_bytes()


@pytest.mark.parametrize("name", CARD_SESSIONS)
def test_card_session_bytes_are_pinned(name):
    assert hashlib.sha256(_session(name)[2]).hexdigest() == BS.PINNED[name]


def test_port_verifier_accepts_card_session():
    root, counts, blob = _session("MIXED_SESSION")
    proof = S.DeferredProof(root, counts[0], proof_from_bytes(blob), *counts[1:])
    S.verify_deferred(proof, root, TEST_PARAMS)


def _miden_tpu_verify(name):
    from miden_tpu.precompile.session import DeferredProof, verify_deferred
    from miden_tpu.stark.proof_io import proof_from_bytes as j_from_bytes
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS

    root, counts, blob = _session(name)
    verify_deferred(DeferredProof(root, counts[0], j_from_bytes(blob), *counts[1:]), root, params=J_TEST_PARAMS)


@pytest.mark.parametrize("name", ["MIXED_SESSION_KECCAK", "MIXED_SESSION_EC"])
def test_miden_tpu_verifier_accepts_card_session(name):
    _miden_tpu_verify(name)
