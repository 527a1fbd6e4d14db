"""Seeded mutation fuzzing of the port's untrusted-input decoders.

The four seeded tests of ``tests/test_fuzz_decoders.py`` on the port's own
decoders (the ``vm/deferred.py`` wire form, the MAST wire form of
``vm/mast_io.py``, ``vm/prove.py`` ``VmProof`` on a synthetic header and on a
real proof), plus ``vm/package.py`` ``MastPackage.from_bytes``: truncations,
bit flips, byte splices and inflated length fields on valid baselines, 300
mutations each. Only the declared format error may escape.
"""

import random

import pytest
import torch

from miden_tpu_torch.vm import deferred as D

N_MUTATIONS = 300


def _mutations(rng, blob: bytes):
    yield blob  # unmutated baseline must round-trip
    yield b""
    yield blob[: len(blob) // 2]
    for _ in range(N_MUTATIONS):
        kind = rng.randrange(4)
        b = bytearray(blob)
        if kind == 0 and len(b) > 1:  # truncate
            del b[rng.randrange(1, len(b)) :]
        elif kind == 1:  # bit flip
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        elif kind == 2:  # splice a random run
            at = rng.randrange(len(b))
            run = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 9)))
            b[at : at + len(run)] = run
        else:  # inflate a 4-byte LE length field
            at = rng.randrange(max(1, len(b) - 4))
            b[at : at + 4] = (0xFFFF_FFFF).to_bytes(4, "little")
        yield bytes(b)


def test_deferred_wire_decoder_survives_mutations():
    st = D.DeferredState(D.default_registry())
    nodes = [D.u256_value_node(x) for x in (7, 9, 16)]
    for n in nodes:
        st.register(n)
    st.log_statement(st.register(D.binop_statement_node(D.PID_U256_ADD, *(n.digest() for n in nodes))))
    blob = st.to_wire().to_bytes()
    accepted = 0
    for mut in _mutations(random.Random(0xDEF), blob):
        try:
            wire = D.DeferredStateWire.from_bytes(mut)
            D.DeferredState.from_wire(D.default_registry(), wire)
            accepted += 1
            assert mut == blob or wire == D.DeferredStateWire.from_bytes(blob)
        except D.IntegrityError:
            pass  # the only acceptable failure mode
    assert accepted >= 1


def test_mast_wire_decoder_survives_mutations():
    from miden_tpu_torch.vm.assembler import assemble
    from miden_tpu_torch.vm.mast_io import MastFormatError, program_from_bytes, program_to_bytes

    blob = program_to_bytes(assemble("begin push.1 push.2 repeat.5 dup.1 add end swap drop end"))
    ok = 0
    for mut in _mutations(random.Random(0xAAB), blob):
        try:
            program_from_bytes(mut)
            ok += 1
        except MastFormatError:
            pass
    assert ok >= 1


@pytest.mark.parametrize("kind", ["program", "library"])
def test_package_decoder_survives_mutations(kind):
    """The port's repaired ``MastPackage.from_bytes`` raises only
    ``MastFormatError`` (``miden_tpu``'s lets ``struct.error`` and
    ``UnicodeDecodeError`` escape)."""
    from miden_tpu_torch.vm.mast_io import MastFormatError
    from miden_tpu_torch.vm.package import MastPackage, assemble_library_package, assemble_program_package

    if kind == "program":
        pkg = assemble_program_package("fuzz", "begin push.1 push.2 repeat.5 dup.1 add end swap drop end",
                                       description="seeded mutations")
    else:
        pkg = assemble_library_package("fuzzlib", {"a::b": "pub proc f\n    add.1 mul.2\nend\n"})
    blob = pkg.to_bytes()
    ok = 0
    for mut in _mutations(random.Random(0x5A5 + len(kind)), blob):
        try:
            MastPackage.from_bytes(mut)
            ok += 1
        except MastFormatError:
            pass
    assert ok >= 1


def test_vm_proof_decoder_survives_mutations():
    from miden_tpu_torch.stark.proof_io import ProofFormatError
    from miden_tpu_torch.vm.prove import VmProof

    header = (
        VmProof.MAGIC + VmProof.VERSION.to_bytes(4, "little") + b"\x00" * (8 * 40)
        + (0).to_bytes(4, "little") + (0).to_bytes(4, "little")
    )
    for mut in _mutations(random.Random(0xCAFE), header + b"\x00" * 64):
        try:
            VmProof.from_bytes(mut)
        except ProofFormatError:
            pass  # the only acceptable failure mode


@pytest.mark.slow
def test_vm_proof_decoder_survives_real_proof_mutations():
    """A real serialized proof (TEST_PARAMS, with a deferred wire), proved
    on the CPU, so that the transcript boundary and the deferred wire's
    length field get mutation coverage."""
    from miden_tpu_torch.stark import TEST_PARAMS
    from miden_tpu_torch.stark.proof_io import ProofFormatError
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.vm.prove import VmProof, prove_program

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _out, proof = prove_program(
            assemble_with_stdlib("use miden::core::crypto::hashes::keccak256\n"
                                 "begin exec.keccak256::merge dropw dropw end"),
            stack_inputs=[3, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0],
            params=TEST_PARAMS, event_handlers=stdlib_event_handlers(), device="cpu",
        )
    finally:
        torch.set_num_threads(threads)
    blob = proof.to_bytes()
    assert proof.deferred_wire, "fixture must carry a deferred wire"
    assert VmProof.from_bytes(blob).to_bytes() == blob
    ok = 0
    for mut in _mutations(random.Random(0xFEED), blob):
        try:
            VmProof.from_bytes(mut)
            ok += 1
        except ProofFormatError:
            pass
    assert ok >= 1
