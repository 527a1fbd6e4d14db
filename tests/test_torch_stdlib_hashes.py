"""The port's in-VM BLAKE3 and SHA-256 (``crypto::hashes::blake3`` /
``sha256``) ≡ miden_tpu's, and ≡ the host hashes.

The programs of ``tests/test_blake3_masm.py`` and ``test_sha256_masm.py``
run through both packages' ``execute``: the stacks must be equal, and equal
to the port's ``blake3_host`` / ``hashlib``. A two-hash BLAKE3 chain's
``CoreTrace`` (core, chiplets and Poseidon2 matrices) equals
``miden_tpu``'s ``execute_and_trace``. The slow case holds the CPU proof of
one ``blake3::hash_1to1`` at ``TEST_PARAMS`` byte-equal to ``miden_tpu``'s.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from miden_tpu.stdlib import assemble_with_stdlib as j_assemble_with_stdlib
from miden_tpu.stdlib import stdlib_event_handlers as j_handlers
from miden_tpu.vm.processor import execute as j_execute
from miden_tpu_torch.hash.blake3_host import blake3
from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
from miden_tpu_torch.vm.processor import execute


def words_le(data: bytes) -> list[int]:
    return [int.from_bytes(data[4 * i : 4 * i + 4], "little") for i in range(len(data) // 4)]


def words_be(data: bytes) -> list[int]:
    return [int.from_bytes(data[4 * i : 4 * i + 4], "big") for i in range(len(data) // 4)]


def hash_program(module: str, proc: str, message_words: list[int], reps: int = 1) -> str:
    """``reps`` applications of ``module::proc`` to the message, word 0 on top."""
    pushes = " ".join(f"push.{v}" for v in reversed(message_words))
    return (
        f"use miden::core::crypto::hashes::{module}\n"
        f"begin {pushes} repeat.{reps} exec.{module}::{proc} end end"
    )


def run_both(src: str) -> list[int]:
    out = execute(assemble_with_stdlib(src), [], event_handlers=stdlib_event_handlers())
    j_out = j_execute(j_assemble_with_stdlib(src), [], event_handlers=j_handlers())
    assert [int(v) for v in out.stack] == [int(v) for v in j_out.stack]
    return [int(v) for v in out.stack]


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
def test_blake3_hash_2to1_equals_miden_tpu_and_the_host(seed):
    data = bytes((seed * 31 + i * 7 + 3) % 256 for i in range(64))
    assert run_both(hash_program("blake3", "hash_2to1", words_le(data)))[:8] == words_le(blake3(data))


@pytest.mark.parametrize("seed", [0, 5])
def test_blake3_hash_1to1_equals_miden_tpu_and_the_host(seed):
    data = bytes((seed * 17 + i * 13 + 1) % 256 for i in range(32))
    assert run_both(hash_program("blake3", "hash_1to1", words_le(data)))[:8] == words_le(blake3(data))


def test_blake3_chain_equals_miden_tpu_and_the_host():
    data = host = bytes(range(32))
    for _ in range(4):
        host = blake3(host)
    assert run_both(hash_program("blake3", "hash_1to1", words_le(data), reps=4))[:8] == words_le(host)


@pytest.mark.parametrize("seed", [0, 3, 255])
def test_sha256_hash_1to1_equals_miden_tpu_and_hashlib(seed):
    data = bytes((seed + 11 * i) % 256 for i in range(32))
    want = words_be(hashlib.sha256(data).digest())
    assert run_both(hash_program("sha256", "hash_1to1", words_be(data)))[:8] == want


@pytest.mark.parametrize("seed", [1, 77])
def test_sha256_hash_2to1_equals_miden_tpu_and_hashlib(seed):
    data = bytes((seed * 3 + 5 * i) % 256 for i in range(64))
    want = words_be(hashlib.sha256(data).digest())
    assert run_both(hash_program("sha256", "hash_2to1", words_be(data)))[:8] == want


def test_sha256_chain_equals_miden_tpu_and_hashlib():
    data = host = bytes(range(32))
    for _ in range(3):
        host = hashlib.sha256(host).digest()
    assert run_both(hash_program("sha256", "hash_1to1", words_be(data), reps=3))[:8] == words_be(host)


def test_blake3_chain_core_trace_equals_miden_tpu():
    """Every matrix and replay log of a two-hash chain's trace, host only:
    the u32 bitwise and memory ops fill the bitwise and memory chiplets."""
    from miden_tpu.vm.trace import execute_and_trace as j_execute_and_trace
    from miden_tpu_torch.vm.trace import execute_and_trace

    pushes = " ".join(f"push.{v}" for v in reversed(words_le(bytes(range(32)))))
    src = (
        "use miden::core::crypto::hashes::blake3\nuse miden::core::sys\n"
        f"begin {pushes} repeat.2 exec.blake3::hash_1to1 end exec.sys::truncate_stack end"
    )
    out, trace = execute_and_trace(assemble_with_stdlib(src), event_handlers=stdlib_event_handlers())
    j_out, j_trace = j_execute_and_trace(j_assemble_with_stdlib(src), event_handlers=j_handlers())
    assert out.stack == j_out.stack and out.clk == j_out.clk
    assert trace.num_real_rows == j_trace.num_real_rows
    assert trace.bitwise_log and trace.mem_log
    for name in ("matrix", "chiplets", "poseidon"):
        mine, theirs = getattr(trace, name), np.asarray(getattr(j_trace, name))
        assert mine.shape == theirs.shape, name
        assert np.array_equal(mine, theirs), name
    for name in ("program_hash", "stack_outputs", "mem_log", "bitwise_log", "range_values"):
        assert list(getattr(trace, name)) == list(getattr(j_trace, name)), name


@pytest.mark.slow
def test_blake3_program_proof_bytes_equal_miden_tpu():
    """One ``hash_1to1`` (core 2^14 rows) proved on the CPU by both packages
    at TEST_PARAMS: minutes."""
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.vm.prove import VmProof as JVmProof
    from miden_tpu.vm.prove import prove_program as j_prove_program
    from miden_tpu.vm.prove import verify_program as j_verify_program
    from miden_tpu_torch.stark import TEST_PARAMS
    from miden_tpu_torch.vm.prove import VmProof, prove_program, verify_program

    data = bytes(range(32))
    src = hash_program("blake3", "hash_1to1", words_le(data))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, proof = prove_program(
            assemble_with_stdlib(src), params=TEST_PARAMS, event_handlers=stdlib_event_handlers(), device="cpu"
        )
    finally:
        torch.set_num_threads(threads)
    assert [int(v) for v in out.stack[:8]] == words_le(blake3(data))
    _, j_proof = j_prove_program(j_assemble_with_stdlib(src), params=J_TEST_PARAMS, event_handlers=j_handlers())
    assert proof.to_bytes() == j_proof.to_bytes()
    verify_program(VmProof.from_bytes(j_proof.to_bytes()), params=TEST_PARAMS)
    j_verify_program(JVmProof.from_bytes(proof.to_bytes()), params=J_TEST_PARAMS)
