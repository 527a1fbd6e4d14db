"""Preprocessed columns in the port's prover ≡ ``miden_tpu``'s, on the CPU.

The statement is ``bench_airs.square_lut_statement(4)``: one AIR whose main
column must equal a committed column of squares plus a public offset (the
AIR of ``tests/test_preprocessed.py``, written here once more against
``miden_tpu``'s ``Air`` for the JAX side). One JAX proof per module, at
``TEST_PARAMS`` with poseidon2 (about a minute and a half of JAX-CPU, almost
all of it XLA compile). The port's preprocessed commitment and proof bytes
must equal ``miden_tpu``'s, both verifiers must accept the port's proof, and
the negative paths of ``tests/test_preprocessed.py`` (wrong commitment,
presence parity, a witness that breaks the constraints) must hold in the
port. An rpo256 proof of the same statement is checked by both verifiers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from miden_tpu.field import gl as jgl
from miden_tpu.stark import Air as JAir
from miden_tpu.stark import MultiAir as JMultiAir
from miden_tpu.stark import Statement as JStatement
from miden_tpu.stark import TEST_PARAMS as J_TEST_PARAMS
from miden_tpu.stark import build_preprocessed as j_build_preprocessed
from miden_tpu.stark import prove as j_prove
from miden_tpu.stark import verify as j_verify
from miden_tpu.stark.debug import check_air as j_check_air
from miden_tpu.stark.proof_io import proof_to_bytes as j_proof_to_bytes
from miden_tpu.transcript import challenger as JC
from miden_tpu_torch import bench_airs as B
from miden_tpu_torch.stark import TEST_PARAMS, VerificationError, build_preprocessed, prove, verify
from miden_tpu_torch.stark.debug import check_air
from miden_tpu_torch.stark.preprocessed import validate_preprocessed
from miden_tpu_torch.stark.proof_io import proof_from_bytes, proof_to_bytes
from miden_tpu_torch.transcript import challenger as C

SEED = [5, 6, 7, 8]
LOG_N = 4
OFFSET = B.SQUARE_LUT_OFFSET


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU's cores; this module's torch
    work is small-tensor dispatch, as fast on one thread, and on eight it
    oversubscribes the cores the other workers use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JSquareLutAir(JAir):
    """``bench_airs.SquareLutAir`` against miden_tpu's folder."""

    width = 1
    preprocessed_width = 1
    num_public_values = 1

    def eval(self, f):
        f.assert_zero(f.main(0) - f.preprocessed(0) - f.public(0))
        f.assert_transition(f.main(0, 1) - f.preprocessed(0, 1) - f.public(0))

    def preprocessed_trace(self):
        return np.asarray([[(i * i) % jgl.P] for i in range(1 << LOG_N)], dtype=np.uint64)


def _j_statement():
    return JStatement(JMultiAir([JSquareLutAir()]), [OFFSET])


def _j_trace():
    return np.asarray([[(i * i + OFFSET) % jgl.P] for i in range(1 << LOG_N)], dtype=np.uint64)


@pytest.fixture(scope="module")
def jax_proof():
    st = _j_statement()
    pp = j_build_preprocessed(st, J_TEST_PARAMS)
    out = j_prove(J_TEST_PARAMS, st, [_j_trace()], JC.DuplexChallenger(SEED), preprocessed=pp)
    return pp.commitment(), j_proof_to_bytes(out.proof), out.digest


def _port(params=TEST_PARAMS):
    st, traces = B.square_lut_statement(LOG_N, device="cpu")
    pp = build_preprocessed(st, params, device="cpu")
    return st, traces, pp


@pytest.fixture(scope="module")
def port_proof():
    st, traces, pp = _port()
    return st, pp, prove(TEST_PARAMS, st, traces, C.DuplexChallenger(SEED), preprocessed=pp, device="cpu")


def test_statement_matches_the_jax_side():
    st, traces, _ = _port()
    assert (traces[0].numpy().view(np.uint64) == _j_trace()).all()
    assert (st.multi_air.airs[0].preprocessed_trace() == JSquareLutAir().preprocessed_trace()).all()
    assert st.publics == [OFFSET]


def test_commitment_equals_miden_tpu(jax_proof, port_proof):
    _, pp, _ = port_proof
    assert pp.commitment() == jax_proof[0]
    assert pp.order == [0]
    assert pp.trace_index_for_air() == {0: 0}


def test_proof_bytes_equal_miden_tpu(jax_proof, port_proof):
    _, _, out = port_proof
    assert proof_to_bytes(out.proof) == jax_proof[1]
    assert out.digest == jax_proof[2]


def test_both_verifiers_accept_the_port_proof(port_proof):
    st, pp, out = port_proof
    assert verify(TEST_PARAMS, st, out.proof, C.DuplexChallenger(SEED),
                  preprocessed_commitment=pp.commitment()) == out.digest
    assert j_verify(J_TEST_PARAMS, _j_statement(), _j_proof(out), JC.DuplexChallenger(SEED),
                    preprocessed_commitment=pp.commitment()) == out.digest


def test_fused_proof_equals_miden_tpu_and_the_eager_proof(jax_proof, port_proof):
    """The fused phases (forced on the CPU), the preprocessed tree among
    their static inputs, give the eager proof's bytes."""
    st, traces, pp = _port()
    out = prove(TEST_PARAMS, st, traces, C.DuplexChallenger(SEED), preprocessed=pp, device="cpu", fused=True)
    _, _, eager = port_proof
    assert proof_to_bytes(out.proof) == proof_to_bytes(eager.proof) == jax_proof[1]
    assert out.digest == eager.digest == jax_proof[2]
    assert j_verify(J_TEST_PARAMS, _j_statement(), _j_proof(out), JC.DuplexChallenger(SEED),
                    preprocessed_commitment=pp.commitment()) == out.digest


def _j_proof(out):
    from miden_tpu.stark.proof_io import proof_from_bytes as j_proof_from_bytes

    return j_proof_from_bytes(proof_to_bytes(out.proof))


def test_wrong_commitment_is_rejected(port_proof):
    st, pp, out = port_proof
    bad = list(pp.commitment())
    bad[0] ^= 1
    # Fiat-Shamir diverges from the first observation: the rejection is a
    # transcript or a verification error, both ValueErrors
    with pytest.raises(ValueError):
        verify(TEST_PARAMS, st, out.proof, C.DuplexChallenger(SEED), preprocessed_commitment=tuple(bad))
    with pytest.raises(ValueError):
        j_verify(J_TEST_PARAMS, _j_statement(), _j_proof(out), JC.DuplexChallenger(SEED),
                 preprocessed_commitment=tuple(bad))


def test_presence_parity_is_enforced(port_proof):
    st, pp, out = port_proof
    _, traces, _ = _port()
    with pytest.raises(ValueError, match="exactly when"):
        prove(TEST_PARAMS, st, traces, C.DuplexChallenger(SEED), device="cpu")
    with pytest.raises(VerificationError, match="exactly when"):
        verify(TEST_PARAMS, st, out.proof, C.DuplexChallenger(SEED))
    shaped, shaped_traces = B.miden_shaped_statement(4, device="cpu")
    with pytest.raises(ValueError, match="exactly when"):
        prove(TEST_PARAMS, shaped, shaped_traces, C.DuplexChallenger(SEED), preprocessed=pp, device="cpu")


def test_validate_preprocessed_rejects_mismatched_shapes():
    st, traces, pp = _port()
    validate_preprocessed(st, traces, pp, TEST_PARAMS)
    with pytest.raises(ValueError, match="height"):
        validate_preprocessed(st, [traces[0][:8]], pp, TEST_PARAMS)
    with pytest.raises(ValueError, match="committed LDE height"):
        validate_preprocessed(st, traces, pp, dataclasses.replace(TEST_PARAMS, log_blowup=2))
    with pytest.raises(ValueError, match="count"):
        validate_preprocessed(st, traces, dataclasses.replace(pp, traces=[]), TEST_PARAMS)
    assert build_preprocessed(B.miden_shaped_statement(4, device="cpu")[0], TEST_PARAMS, device="cpu") is None


def test_bad_witness_is_rejected_by_the_constraints():
    air = B.SquareLutAir(LOG_N)
    table = air.preprocessed_trace()
    good = (table.astype(object) + OFFSET) % jgl.P
    bad = np.asarray(good, dtype=np.uint64)
    bad[5, 0] = 999
    violations = check_air(air, bad, preprocessed=table, publics=[OFFSET])
    j_violations = j_check_air(JSquareLutAir(), bad, preprocessed=table, publics=[OFFSET])
    assert violations and [(v.row, v.index) for v in violations] == [(v.row, v.index) for v in j_violations]
    assert not check_air(air, np.asarray(good, dtype=np.uint64), preprocessed=table, publics=[OFFSET])


def test_rpo256_proof_is_accepted_by_both_verifiers():
    params = dataclasses.replace(TEST_PARAMS, hash_name="rpo256")
    st, traces, pp = _port(params)
    out = prove(params, st, traces, C.DuplexChallenger(SEED), preprocessed=pp, device="cpu")
    assert verify(params, st, proof_from_bytes(proof_to_bytes(out.proof)), C.DuplexChallenger(SEED),
                  preprocessed_commitment=pp.commitment()) == out.digest
    j_params = dataclasses.replace(J_TEST_PARAMS, hash_name="rpo256")
    assert j_verify(j_params, _j_statement(), _j_proof(out), JC.DuplexChallenger(SEED),
                    preprocessed_commitment=pp.commitment()) == out.digest
    # the rpo256 commitment is not the poseidon2 one
    assert pp.commitment() != _port()[2].commitment()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        B.square_lut_statement(LOG_N)
    st, _ = B.square_lut_statement(LOG_N, device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        build_preprocessed(st, TEST_PARAMS)
