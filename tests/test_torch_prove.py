"""The port's prover ≡ miden_tpu's prover, on the CPU.

One JAX proof per run (a cold JAX-CPU prove costs about two minutes, almost
all of it XLA compile): ``miden_shaped_statement(6)`` at ``TEST_PARAMS``,
shared by the byte-equality and cross-verification tests through a
module-scoped fixture. The port's proof of the same statement must be
byte-equal, each package's verifier must accept the other's proof, and a
tampered public value must be rejected.

The shaped statement's traces are zero, where most constraint values
vanish, so the stages that carry data are also held equal to their JAX
counterparts on random inputs (quotient evaluation per AIR, OOD claims, DEEP
quotient, FRI fold, quotient chunks). Larger proofs and proofs of random
(invalid) traces run on the port alone.
"""

import numpy as np
import pytest
import torch

from miden_tpu import bench_airs as JB
from miden_tpu.field.goldilocks import Fp2, fp2_from_pairs_u64, fp2_to_pairs_u64, fp_from_u64, fp_to_u64
from miden_tpu.merkle import lmcs as JL
from miden_tpu.stark import TEST_PARAMS as J_TEST_PARAMS
from miden_tpu.stark import pcs as JP
from miden_tpu.stark import prover as JPR
from miden_tpu.stark import verify as j_verify
from miden_tpu.stark.domains import LiftedDomain as JDomain
from miden_tpu.stark.proof_io import proof_to_bytes as j_proof_to_bytes
from miden_tpu.transcript import challenger as JC
from miden_tpu_torch import bench_airs as B
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.merkle import lmcs as L
from miden_tpu_torch.stark import TEST_PARAMS, VerificationError, pcs, prove, prover, verify
from miden_tpu_torch.stark.domains import LiftedDomain
from miden_tpu_torch.stark.proof_io import proof_from_bytes, proof_to_bytes
from miden_tpu_torch.transcript import challenger as C

SEED = [11, 22, 33, 44]


@pytest.fixture(scope="module")
def jax_proof():
    statement, traces = JB.miden_shaped_statement(6)
    return JPR.prove(J_TEST_PARAMS, statement, traces, JC.DuplexChallenger(SEED))


@pytest.fixture(scope="module")
def port_proof():
    statement, traces = B.miden_shaped_statement(6, device="cpu")
    return prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu")


def test_proof_bytes_equal_miden_tpu(jax_proof, port_proof):
    assert proof_to_bytes(port_proof.proof) == j_proof_to_bytes(jax_proof.proof)
    assert port_proof.digest == jax_proof.digest


def test_miden_tpu_verifier_accepts_the_port_proof(port_proof):
    from miden_tpu.stark.proof_io import proof_from_bytes as j_proof_from_bytes

    statement, _ = JB.miden_shaped_statement(6)
    proof = j_proof_from_bytes(proof_to_bytes(port_proof.proof))
    assert j_verify(J_TEST_PARAMS, statement, proof, JC.DuplexChallenger(SEED)) == port_proof.digest


def test_fused_proof_equals_miden_tpu_and_the_eager_proof(jax_proof, port_proof):
    """The fused phases (forced on the CPU) give the eager proof's bytes, and
    miden_tpu's verifier accepts them."""
    from miden_tpu.stark.proof_io import proof_from_bytes as j_proof_from_bytes

    statement, traces = B.miden_shaped_statement(6, device="cpu")
    out = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=True)
    assert proof_to_bytes(out.proof) == proof_to_bytes(port_proof.proof) == j_proof_to_bytes(jax_proof.proof)
    assert out.digest == port_proof.digest == jax_proof.digest
    jstatement, _ = JB.miden_shaped_statement(6)
    proof = j_proof_from_bytes(proof_to_bytes(out.proof))
    assert j_verify(J_TEST_PARAMS, jstatement, proof, JC.DuplexChallenger(SEED)) == out.digest


def test_port_verifier_accepts_the_miden_tpu_proof(jax_proof):
    statement, _ = B.miden_shaped_statement(6, device="cpu")
    proof = proof_from_bytes(j_proof_to_bytes(jax_proof.proof))
    assert verify(TEST_PARAMS, statement, proof, C.DuplexChallenger(SEED)) == jax_proof.digest


def test_tampered_public_value_is_rejected(port_proof):
    statement, _ = B.miden_shaped_statement(6, device="cpu")
    statement.publics[3] = 1
    with pytest.raises(ValueError):  # VerificationError / TranscriptError
        verify(TEST_PARAMS, statement, port_proof.proof, C.DuplexChallenger(SEED))
    jstatement, _ = JB.miden_shaped_statement(6)
    jstatement.publics[3] = 1
    from miden_tpu.stark.proof_io import proof_from_bytes as j_proof_from_bytes

    with pytest.raises(ValueError):
        j_verify(J_TEST_PARAMS, jstatement, j_proof_from_bytes(proof_to_bytes(port_proof.proof)),
                 JC.DuplexChallenger(SEED))


def test_port_proves_and_verifies_a_larger_statement():
    statement, traces = B.miden_shaped_statement(8, device="cpu")
    out = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu")
    proof = proof_from_bytes(proof_to_bytes(out.proof))
    assert proof.log_heights == [8, 6, 4]
    assert verify(TEST_PARAMS, statement, proof, C.DuplexChallenger(SEED)) == out.digest


def test_random_traces_prove_but_do_not_verify():
    statement, traces = B.miden_shaped_statement(5, device="cpu")
    rng = np.random.default_rng(5)
    traces = [rng.integers(0, gl.P, size=tuple(t.shape), dtype=np.uint64) for t in traces]
    out = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu")
    with pytest.raises(VerificationError):
        verify(TEST_PARAMS, statement, out.proof, C.DuplexChallenger(SEED))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        B.miden_shaped_statement(4)
    statement, traces = B.miden_shaped_statement(4, device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED))


# ---------------------------------------------------------------------------
# Data-carrying stages on random inputs
# ---------------------------------------------------------------------------


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)


def _t(a):
    return F.to_torch(a, "cpu")


@pytest.mark.parametrize("air_index", [0, 1, 2])
def test_evaluate_quotient_matches_miden_tpu(air_index):
    air = B.miden_shaped_statement(4, device="cpu")[0].multi_air.airs[air_index]
    jair = JB.miden_shaped_statement(4)[0].multi_air.airs[air_index]
    log_trace, log_d = 4, 1
    dom, jdom = LiftedDomain(log_trace, 3, 0), JDomain(log_trace, 3, 0)
    main = _rand(air_index, (dom.lde_height, air.width))
    aux = _rand(10 + air_index, (dom.lde_height, 2 * air.aux_width)) if air.aux_width else None
    alpha = _rand(20, (2,))
    publics = _rand(21, (32,))
    rand = _rand(22, (air.num_randomness, 2))
    auxv = _rand(23, (air.num_aux_values, 2))
    got = prover.evaluate_quotient(
        air, dom, _t(main), None if aux is None else _t(aux), log_d, _t(alpha), _t(publics),
        _t(rand), _t(auxv),
    )
    want = JPR.evaluate_quotient(
        jair, jdom, fp_from_u64(main), None if aux is None else fp_from_u64(aux), log_d,
        fp2_from_pairs_u64(alpha), fp_from_u64(publics), fp2_from_pairs_u64(rand),
        fp2_from_pairs_u64(auxv),
    )
    assert (F.to_numpy(got) == fp2_to_pairs_u64(want)).all()


def _trees(seed):
    mats = [_rand(seed, (64, 5)), _rand(seed + 1, (16, 9)), _rand(seed + 2, (64, 4))]
    groups = [[0, 1], [2]]
    trees = [L.build_tree([_t(mats[i]) for i in g]) for g in groups]
    jtrees = [JL.build_tree([fp_from_u64(mats[i]) for i in g]) for g in groups]
    return trees, jtrees


def test_deep_claims_and_quotient_match_miden_tpu():
    trees, jtrees = _trees(30)
    zs = [_rand(31, (2,)), _rand(32, (2,))]
    alpha, beta = _rand(33, (2,)), _rand(34, (2,))
    claims = pcs.compute_deep_claims(trees, [_t(z) for z in zs])
    jzs = [fp2_from_pairs_u64(z) for z in zs]
    jclaims = JP.compute_deep_claims(jtrees, jzs)
    assert claims.aligned_widths == jclaims.aligned_widths
    for mine, theirs in zip(claims.evals, jclaims.evals):
        for m, t in zip(mine, theirs):
            assert (F.to_numpy(m) == fp2_to_pairs_u64(t)).all()
    dom, jdom = LiftedDomain(3, 3, 0), JDomain(3, 3, 0)
    got = pcs.deep_compose(dom, trees, claims, [_t(z) for z in zs], _t(alpha), _t(beta))
    want = JP.deep_compose(jdom, jtrees, jclaims, jzs, fp2_from_pairs_u64(alpha), fp2_from_pairs_u64(beta))
    assert (F.to_numpy(got) == fp2_to_pairs_u64(want)).all()


@pytest.mark.parametrize("log_arity", [1, 2])
def test_fri_fold_matches_miden_tpu(log_arity):
    rows = 16
    mat = _rand(40 + log_arity, (rows, 1 << log_arity, 2))
    x_inv, beta = _rand(41, (rows,)), _rand(42, (2,))
    got = pcs._fold_rows_dev(log_arity, _t(mat), _t(x_inv), _t(beta))
    jmat = Fp2(fp_from_u64(mat[..., 0]), fp_from_u64(mat[..., 1]))
    want = JP._fold_rows_dev(log_arity, jmat, fp_from_u64(x_inv), fp2_from_pairs_u64(beta))
    assert (F.to_numpy(got) == fp2_to_pairs_u64(want)).all()


def test_final_poly_upsample_and_quotient_chunks_match_miden_tpu():
    evals = _rand(50, (32, 2))
    shift = gl.canonical_lde_shift(5)
    got = pcs._final_poly_dev(4, _t(evals), shift)
    want = JP._final_poly_dev(4, fp2_from_pairs_u64(evals), shift)
    assert (F.to_numpy(got) == fp2_to_pairs_u64(want)).all()
    got = prover.upsample_evals(_t(evals), shift, 1)
    want = JPR.upsample_evals(fp2_from_pairs_u64(evals), shift, 1)
    assert (F.to_numpy(got) == fp2_to_pairs_u64(want)).all()
    dom, jdom = LiftedDomain(4, 3, 0), JDomain(4, 3, 0)
    got = prover._quotient_chunks_dev(_t(evals), dom, 1, 3)
    want = JPR._quotient_chunks_dev(fp2_from_pairs_u64(evals), jdom, 1, 3)
    assert (F.to_numpy(got) == fp_to_u64(want)).all()


def test_running_sum_aux_matches_miden_tpu():
    from miden_tpu.stark import aux as JA
    from miden_tpu_torch.stark import aux as A

    terms = _rand(60, (32, 2))
    got, got_final = A.running_sum_aux(_t(terms))
    want, want_final = JA.running_sum_aux(fp2_from_pairs_u64(terms))
    assert (got == want).all() and got_final == want_final
    cols = _rand(61, (16, 3, 2))
    inter, last = A.running_sum_aux_columns(_t(cols))
    jinter, jlast = JA.running_sum_aux_columns(fp2_from_pairs_u64(cols))
    assert (F.to_numpy(inter) == fp_to_u64(jinter)).all()
    assert (F.to_numpy(last) == fp2_to_pairs_u64(jlast)).all()


def test_spans_carry_the_reference_phase_names():
    from miden_tpu_torch.utils.tracing import Recorder

    statement, traces = B.miden_shaped_statement(4, device="cpu")
    with Recorder() as rec:
        prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu")
    assert {
        "commit to main traces", "build aux traces", "commit to aux traces", "evaluate constraints",
        "commit to quotient poly chunks", "evaluate at OOD points", "DEEP reduce + assemble",
        "FRI round commit", "FRI fold", "query grind", "query phase",
    } <= set(rec.totals)
    assert rec.totals["evaluate constraints"][1] == 3  # one span per AIR
