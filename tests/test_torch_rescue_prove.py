"""The port's VM proofs under the rpo256 and rpx256 commitment hashes, on
the CPU, against ``miden_tpu``'s verifier.

The fib program of ``tests/test_vm_prove.py`` at ``TEST_PARAMS`` with
``hash_name`` rpo256 and rpx256 (and poseidon2, for the cross-hash cases),
proved once per module by the port on the CPU. ``miden_tpu``'s own prover
cannot be the reference here: its rpo256 / rpx256 trees absorb their leaves
with Poseidon2 (``miden_tpu/merkle/lmcs.py:373``, pinned in
``tests/test_torch_rescue.py``), so its proofs do not verify. Its verifier
is right, and both verifiers must accept the port's proofs and reject
tampered ones. Every rejection is a ``ValueError`` (``VerificationError``,
``TranscriptError``, ``ProofFormatError`` and the LMCS root check all are).

The slow test repairs ``miden_tpu``'s leaf sponge at run time, changing no
file, and holds the port's rpo256 proof bytes equal to that reference's.
"""

import dataclasses

import pytest
import torch

from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
from miden_tpu.vm.prove import VmProof as JVmProof
from miden_tpu.vm.prove import verify_program as j_verify_program
from miden_tpu_torch.stark import TEST_PARAMS
from miden_tpu_torch.vm import assemble
from miden_tpu_torch.vm.prove import VmProof, prove_program, verify_program

FIB = "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end"
HASHES = ["rpo256", "rpx256"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU's cores; this module's torch
    work is small-tensor dispatch, as fast on one thread, and on eight it
    oversubscribes the cores the other workers use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(hash_name):
    return dataclasses.replace(TEST_PARAMS, hash_name=hash_name)


def _j_params(hash_name):
    return dataclasses.replace(J_TEST_PARAMS, hash_name=hash_name)


@pytest.fixture(scope="module")
def proofs():
    """hash name -> the port's VmProof of FIB, made on the CPU."""
    return {h: prove_program(assemble(FIB), params=_params(h), device="cpu")[1]
            for h in ["poseidon2", *HASHES]}


def _both_verify(blob: bytes, hash_name: str) -> None:
    verify_program(VmProof.from_bytes(blob), params=_params(hash_name))
    j_verify_program(JVmProof.from_bytes(blob), params=_j_params(hash_name))


def _both_reject(blob: bytes, hash_name: str) -> None:
    with pytest.raises(ValueError):
        verify_program(VmProof.from_bytes(blob), params=_params(hash_name))
    with pytest.raises(ValueError):
        j_verify_program(JVmProof.from_bytes(blob), params=_j_params(hash_name))


@pytest.mark.parametrize("hash_name", HASHES)
def test_both_verifiers_accept_the_port_proof(proofs, hash_name):
    proof = proofs[hash_name]
    assert proof.stack_outputs[0] == 89  # fib(11)
    assert proof.stark.log_heights == [6, 4, 6]
    _both_verify(proof.to_bytes(), hash_name)


@pytest.mark.parametrize("hash_name", HASHES)
def test_the_commitments_differ_by_hash(proofs, hash_name):
    # the same statement and trace heights; the roots, and with them every
    # challenge and query, differ
    assert proofs[hash_name].stark.log_heights == proofs["poseidon2"].stark.log_heights
    assert proofs[hash_name].stark.data.commitments[0] != proofs["poseidon2"].stark.data.commitments[0]
    assert proofs[hash_name].to_bytes() != proofs["poseidon2"].to_bytes()


@pytest.mark.parametrize("hash_name", HASHES)
def test_a_tampered_public_value_is_rejected(proofs, hash_name):
    bad = dataclasses.replace(proofs[hash_name], stack_outputs=[90] + list(proofs[hash_name].stack_outputs[1:]))
    _both_reject(bad.to_bytes(), hash_name)


@pytest.mark.parametrize("hash_name", HASHES)
def test_tampered_proof_bytes_are_rejected(proofs, hash_name):
    blob = bytearray(proofs[hash_name].to_bytes())
    blob[-40] ^= 1  # inside the last opening's sibling digests
    _both_reject(bytes(blob), hash_name)


@pytest.mark.parametrize("made,checked", [
    ("rpo256", "poseidon2"), ("poseidon2", "rpo256"), ("rpx256", "rpo256"), ("rpo256", "rpx256"),
])
def test_a_proof_is_rejected_under_another_hash(proofs, made, checked):
    _both_reject(proofs[made].to_bytes(), checked)


@pytest.mark.slow
def test_proof_bytes_equal_a_repaired_miden_tpu(proofs, monkeypatch):
    """miden_tpu with its leaf sponge repaired at run time (its commit
    function absorbs with ``rescue.rpo_permute``) makes the port's rpo256
    proof bytes."""
    from miden_tpu.field.goldilocks import Fp, fp_concat, fp_zeros
    from miden_tpu.hash import rescue as JR
    from miden_tpu.merkle import lmcs as JL
    from miden_tpu.vm import assemble as j_assemble
    from miden_tpu.vm.prove import prove_program as j_prove_program

    def leaves(matrices, heights, max_h):
        state = fp_zeros((12, max_h))
        for m, h in zip(matrices, heights):
            flat = JL._lift_pad_concat([m], [h], max_h)
            for c0 in range(0, flat.shape[1], JL.ALIGNMENT):
                chunk = Fp(flat.lo[:, c0 : c0 + 8].T, flat.hi[:, c0 : c0 + 8].T)
                state = JR.rpo_permute(fp_concat([chunk, state[8:12]], axis=0))
        return Fp(state.lo[:4].T, state.hi[:4].T)

    monkeypatch.setattr(JL, "_sponge_leaves_incremental", leaves)
    monkeypatch.setattr(JL, "_COMMIT_FNS", {})
    _, j_proof = j_prove_program(j_assemble(FIB), params=_j_params("rpo256"))
    assert j_proof.to_bytes() == proofs["rpo256"].to_bytes()
