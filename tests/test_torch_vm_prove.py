"""The port's VM facade ≡ miden_tpu's: ``prove_program`` / ``verify_program``.

One JAX VM proof per run (about three minutes of JAX-CPU, almost all of it
XLA compile), made in one test, so that no scheduling of the tests across
workers can make it twice: the fib program of ``tests/test_vm_prove.py`` at
``TEST_PARAMS``. The port proves the same program on the CPU; its
``VmProof.to_bytes()`` must equal ``miden_tpu``'s, each package's
``verify_program`` must accept the other's proof, and the port must reject
tampered public claims.
"""

import dataclasses

import pytest
import torch

from miden_tpu.stark.params import MIDEN_PARAMS as J_MIDEN_PARAMS
from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
from miden_tpu.vm import assemble as j_assemble
from miden_tpu.vm.prove import VmProof as JVmProof
from miden_tpu.vm.prove import prove_program as j_prove_program
from miden_tpu.vm.prove import verify_program as j_verify_program
from miden_tpu_torch.field import gl
from miden_tpu_torch.stark import MIDEN_PARAMS, TEST_PARAMS, VerificationError
from miden_tpu_torch.stark.proof_io import ProofFormatError
from miden_tpu_torch.vm import assemble
from miden_tpu_torch.vm.prove import VmProof, prove_program, verify_program

FIB = "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end"


@pytest.fixture(scope="module")
def port_proof():
    return prove_program(assemble(FIB), params=TEST_PARAMS, device="cpu")


def test_proof_bytes_equal_miden_tpu(port_proof):
    _, j_proof = j_prove_program(j_assemble(FIB), params=J_TEST_PARAMS)
    jax_proof = j_proof.to_bytes()
    _, proof = port_proof
    assert proof.to_bytes() == jax_proof
    # the port's verifier accepts the miden_tpu proof
    verify_program(VmProof.from_bytes(jax_proof), params=TEST_PARAMS)


def test_port_proof_claims_fib(port_proof):
    out, proof = port_proof
    assert out.stack[0] == 89  # fib(11)
    assert proof.stack_outputs[0] == 89
    assert proof.stark.log_heights == [6, 4, 6]  # core, chiplets, poseidon


def test_miden_tpu_verifier_accepts_the_port_proof(port_proof):
    _, proof = port_proof
    j_verify_program(JVmProof.from_bytes(proof.to_bytes()), params=J_TEST_PARAMS)


def _tampered(proof, what):
    if what == "outputs":
        return dataclasses.replace(proof, stack_outputs=[123] + list(proof.stack_outputs[1:]))
    if what == "inputs":
        return dataclasses.replace(proof, stack_inputs=[7] + list(proof.stack_inputs[1:]))
    ph = list(proof.program_hash)
    ph[0] ^= 1
    return dataclasses.replace(proof, program_hash=tuple(ph))


@pytest.mark.parametrize("what", ["outputs", "inputs", "program_hash"])
def test_tampered_claim_is_rejected(port_proof, what):
    _, proof = port_proof
    with pytest.raises(VerificationError):
        verify_program(_tampered(proof, what), params=TEST_PARAMS)


def test_proof_bytes_round_trip_and_corruption(port_proof):
    _, proof = port_proof
    blob = proof.to_bytes()
    back = VmProof.from_bytes(blob)
    assert back.to_bytes() == blob
    verify_program(back, params=TEST_PARAMS)
    corrupt = bytearray(blob)
    corrupt[10] ^= 1  # inside the program hash
    with pytest.raises((ProofFormatError, VerificationError)):
        verify_program(VmProof.from_bytes(bytes(corrupt)), params=TEST_PARAMS)


def test_deferred_root_resolution_waits_for_the_precompile_slice(port_proof):
    _, proof = port_proof
    bound = dataclasses.replace(proof, deferred_root=(1, 2, 3, 4))
    with pytest.raises(VerificationError):  # no session proof supplied
        verify_program(bound, params=TEST_PARAMS)
    from miden_tpu_torch.precompile.session import DeferredProof

    wrong = DeferredProof(root=(1, 2, 3, 5), n_claims=1, stark=None)
    with pytest.raises(VerificationError, match="deferred root mismatch"):
        verify_program(bound, params=TEST_PARAMS, deferred=wrong)
    with pytest.raises(VerificationError):  # nothing to resolve
        verify_program(proof, params=TEST_PARAMS, deferred=object())


def test_prove_program_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        prove_program(assemble(FIB), params=TEST_PARAMS)


@pytest.mark.slow
def test_proof_bytes_equal_miden_tpu_at_miden_params():
    _, j_proof = j_prove_program(j_assemble(FIB), params=J_MIDEN_PARAMS)
    out, proof = prove_program(assemble(FIB), params=MIDEN_PARAMS, device="cpu")
    assert out.stack[0] == 89 % gl.P
    assert proof.to_bytes() == j_proof.to_bytes()
    verify_program(VmProof.from_bytes(j_proof.to_bytes()), params=MIDEN_PARAMS)
    j_verify_program(JVmProof.from_bytes(proof.to_bytes()), params=J_MIDEN_PARAMS)


@pytest.mark.parametrize("air_index", [0, 1, 2])
def test_quotient_in_blocks_equals_one_block(monkeypatch, air_index):
    # the VM AIRs' quotient goes through the recorded constraint program,
    # whose plain twin (the CPU side of Q1) walks the points in blocks, as
    # the eager evaluator does below 2^21 points; the blocks must give the
    # values of one pass over the domain
    import numpy as np

    from miden_tpu_torch.field import goldilocks as F
    from miden_tpu_torch.stark import interp, prover
    from miden_tpu_torch.stark.domains import LiftedDomain
    from miden_tpu_torch.vm.constraints import CoreVmAir
    from miden_tpu_torch.vm.constraints.chiplets_air import ChipletsVmAir
    from miden_tpu_torch.vm.constraints.poseidon2_air import Poseidon2PermutationAir

    air = [CoreVmAir, ChipletsVmAir, Poseidon2PermutationAir][air_index]()
    rng = np.random.default_rng(70 + air_index)

    def rand(*shape):
        return F.to_torch(rng.integers(0, gl.P, size=shape, dtype=np.uint64), "cpu")

    dom = LiftedDomain(4, 3, 0)
    args = (
        air, dom, rand(dom.lde_height, air.width), rand(dom.lde_height, 2 * air.aux_width), 3,
        rand(2), rand(40), rand(air.num_randomness, 2), rand(air.num_aux_values, 2),
    )
    whole = prover.evaluate_quotient(*args)
    prog = interp.get_program(air, 40, air.num_randomness, air.num_aux_values)
    monkeypatch.setattr(prover, "QUOTIENT_BLOCK_LOG", 5)  # 4 blocks of 32 points
    monkeypatch.setattr(interp, "PLAIN_BLOCK_ELEMS", 32 * (prog.frame_size + prog.n_vec))
    assert interp.plain_block_points(prog, dom.lde_height) == 32
    assert torch.equal(prover.evaluate_quotient(*args), whole)


def test_partial_verification_checks_the_deferred_wire(port_proof):
    from miden_tpu_torch.vm import deferred as D

    _, proof = port_proof
    st = D.DeferredState(D.default_registry())
    nodes = [D.u256_value_node(x) for x in (5, 6, 11)]
    for node in nodes:
        st.register(node)
    st.log_statement(st.register(D.binop_statement_node(D.PID_U256_ADD, *(n.digest() for n in nodes))))
    wire = st.to_wire().to_bytes()
    other_root = dataclasses.replace(proof, deferred_root=(1, 2, 3, 4), deferred_wire=wire)
    with pytest.raises(VerificationError, match="does not open"):
        verify_program(other_root, params=TEST_PARAMS, partial=True)
    broken = dataclasses.replace(proof, deferred_root=st.root, deferred_wire=wire[:-1])
    with pytest.raises(VerificationError, match="deferred wire rejected"):
        verify_program(broken, params=TEST_PARAMS, partial=True)
    # a wire that opens the bound root passes on to the STARK, which was
    # proved for the zero root and rejects the changed public values
    opened = dataclasses.replace(proof, deferred_root=st.root, deferred_wire=wire)
    with pytest.raises(VerificationError) as err:
        verify_program(opened, params=TEST_PARAMS, partial=True)
    assert "deferred wire" not in str(err.value)
