"""The port's fused prover (``miden_tpu_torch/stark/fused.py``) on the CPU.

On the CPU the five phases run eagerly, every proof of a shape on the
layout of the plan that the card captures into CUDA graphs, so a value that
a phase takes from the plan's first proof instead of its inputs shows here
as a wrong proof of the second program of a shape. The fib program's eager
proof is held to ``miden_tpu``'s in ``tests/test_torch_vm_prove.py``; here
its fused proof is held to that eager proof, and a second program of the
same shape, proved through the same plan, to its own eager proof.
"""

import gc
import os
import weakref

import pytest
import torch

from miden_tpu_torch import bench_airs as B
from miden_tpu_torch.dist.context import use_mesh
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.stark import TEST_PARAMS, fused, prove, verify
from miden_tpu_torch.stark.fused import prove_fused, use_fused
from miden_tpu_torch.stark.proof_io import proof_to_bytes
from miden_tpu_torch.transcript import challenger as C
from miden_tpu_torch.utils import cuda
from miden_tpu_torch.utils.tracing import Recorder
from miden_tpu_torch.vm import assemble
from miden_tpu_torch.vm.prove import prove_program, verify_program

FIB = "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end"
#: another program hash and other stack inputs, the same log heights [6, 4, 6]
FIB_OTHER = "begin push.0 push.1 repeat.9 swap dup.1 add end swap drop swap drop end"
SEED = [11, 22, 33, 44]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU's cores; this module's torch
    work is small-tensor dispatch, as fast on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    fused.release()


def _vm_bytes(src, stack_inputs, use):
    out, proof = prove_program(assemble(src), stack_inputs, params=TEST_PARAMS, device="cpu", fused=use)
    return out, proof


@pytest.fixture(scope="module")
def fib_proofs():
    """Eager and fused proofs of FIB, then of FIB_OTHER, in that order, with
    the fused plan after each fused proof."""
    fused.release()
    proofs, plans = {}, {}
    for name, src, inputs in (("fib", FIB, None), ("other", FIB_OTHER, [3, 5])):
        proofs[name, False] = _vm_bytes(src, inputs, False)[1]
        proofs[name, True] = _vm_bytes(src, inputs, True)[1]
        plans[name] = fused.cached_plan()
    return proofs, plans


def test_fused_fib_proof_equals_the_eager_proof(fib_proofs):
    proofs, _ = fib_proofs
    assert proofs["fib", True].stark.log_heights == [6, 4, 6]
    assert proofs["fib", True].to_bytes() == proofs["fib", False].to_bytes()
    verify_program(proofs["fib", True], params=TEST_PARAMS)


def test_two_programs_of_one_shape_through_one_plan(fib_proofs):
    """The second program replays the first one's plan and still gives its
    own proof (another program hash, other stack inputs)."""
    proofs, plans = fib_proofs
    assert proofs["other", False].stark.log_heights == [6, 4, 6]
    assert plans["other"] is plans["fib"]
    assert plans["other"].calls == 2
    assert proofs["other", True].to_bytes() == proofs["other", False].to_bytes()
    assert proofs["other", True].to_bytes() != proofs["fib", True].to_bytes()
    verify_program(proofs["other", True], params=TEST_PARAMS)


def _shaped(log_n):
    statement, traces = B.miden_shaped_statement(log_n, device="cpu")
    return statement, traces


def test_plan_is_reused_for_a_key_and_freed_on_a_new_key():
    fused.release()
    statement, traces = _shaped(4)
    first = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=True)
    plan = fused.cached_plan()
    again = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=True)
    assert fused.cached_plan() is plan and plan.calls == 2
    assert proof_to_bytes(again.proof) == proof_to_bytes(first.proof)
    gone = weakref.ref(plan)
    del plan
    statement, traces = _shaped(5)
    prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=True)
    gc.collect()
    assert gone() is None
    assert fused.cached_plan().key[1] == tuple(t.shape[0].bit_length() - 1 for t in traces)
    fused.release()
    assert fused.cached_plan() is None


def test_fused_proof_runs_the_five_phases_and_verifies():
    """One span a phase, in order; the proof verifies."""
    fused.release()
    statement, traces = _shaped(4)
    with Recorder() as rec:
        out = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=True)
    phases = [name.removeprefix("fused phase: ") for name in rec.totals if name.startswith("fused phase: ")]
    assert phases == ["main", "aux", "quotient", "open", "final"]
    assert all(rec.totals[f"fused phase: {p}"][1] == 1 for p in phases)
    plan = fused.cached_plan()
    # nothing is captured on the CPU, and an eager run leaves nothing in the plan
    assert plan.phase_stats() == {} and not plan.captured
    assert plan.inputs is None and plan.run is None
    statement, _ = _shaped(4)
    assert verify(TEST_PARAMS, statement, out.proof, C.DuplexChallenger(SEED)) == out.digest


def test_use_fused_policy():
    assert use_fused("cuda") and use_fused(torch.device("cuda:0"))
    assert not use_fused("cpu")
    assert use_fused("cpu", fused=True) and not use_fused("cuda", fused=False)
    with use_mesh(object()):
        assert not use_fused("cuda")
        assert not use_fused("cpu", fused=False)
        with pytest.raises(ValueError):
            use_fused("cuda", fused=True)


def test_fused_false_takes_the_eager_path(monkeypatch):
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return prove_fused(*args, **kwargs)

    monkeypatch.setattr(fused, "prove_fused", counting)
    fused.release()
    statement, traces = _shaped(4)
    eager = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=False)
    default = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu")
    assert not calls and fused.cached_plan() is None
    forced = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=True)
    assert calls == [1]
    assert proof_to_bytes(eager.proof) == proof_to_bytes(default.proof) == proof_to_bytes(forced.proof)
    fused.release()


def test_launch_log_counts_on_replay():
    """A launch recorded during a capture counts once for each replay."""
    kern = cuda.Kernel("ntt", "no_such_symbol", [], "no_such_kernel")
    log = cuda.LaunchLog()
    log.add(kern, (10, 4))
    log.add(kern, (10, 4))
    log.add(kern, (12, 4))
    assert kern.launches == 0 and log.total() == 3 and log.per_kernel() == {kern: 3}
    log.replay()
    log.replay()
    assert kern.launches == 6 and kern.shapes == {(10, 4): 4, (12, 4): 2}
    with cuda.recording_launches() as rec:
        assert cuda._recording is rec
    assert cuda._recording is None


#: device function names as the CUDA driver API (mangled) and the profiler (demangled)
#: give them, and the kernel entry each belongs to
DEVICE_FUNCTIONS = [
    ("_Z14permute_kernelIN12_GLOBAL__N_13RpoEEvPKmPml", "rpo_permute"),
    ("void permute_kernel<(anonymous namespace)::Rpx>(unsigned long const*, unsigned long*, long)", "rpx_permute"),
    ("_Z18absorb_rows_kernelIN12_GLOBAL__N_19Poseidon2EEvPKmPmS2_lill", "poseidon2_absorb_rows"),
    ("void compress_rows_kernel<(anonymous namespace)::Poseidon2>(unsigned long const*, unsigned long*, long)",
     "poseidon2_compress_rows"),
    ("_ZN12_GLOBAL__N_120col_transform_kernelILb1EEEvPKmPmS2_iliS2_", "ntt_col_transform"),
    ("void (anonymous namespace)::transpose_twiddle_kernel(unsigned long const*, unsigned long*, "
     "unsigned long const*, long, long, int, int)", "ntt_transpose_twiddle"),
    ("_ZN12_GLOBAL__N_123constraints_eval_kernelILi2EEEvPKml", "constraints_eval"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<long> >(int)", None),
    ("_Z14permute_kernelIN12_GLOBAL__N_16OtherPEEvPKmPml", None),
]


@pytest.mark.parametrize("name,symbol", DEVICE_FUNCTIONS)
def test_kernel_named_finds_the_kernel_of_a_device_function(name, symbol):
    """How a graph's kernel nodes and the profiler's kernel events are
    counted against the port's kernels."""
    from miden_tpu_torch.hash import poseidon2, rescue  # noqa: F401  (their kernels)
    from miden_tpu_torch.ntt import ntt  # noqa: F401
    from miden_tpu_torch.stark import interp  # noqa: F401

    kernel = cuda.kernel_named(name)
    assert (kernel.symbol if kernel is not None else None) == symbol


def test_constant_tables_are_uploaded_once():
    a = F.table([1, 2, 3], "cpu")
    assert F.table([1, 2, 3], "cpu") is a
    assert F.table([1, 2, 4], "cpu") is not a
    assert F.to_numpy(a).tolist() == [1, 2, 3]


def test_release_forgets_the_constant_tables():
    a = F.table([5, 6, 7], "cpu")
    fused.release()
    b = F.table([5, 6, 7], "cpu")
    assert b is not a and F.to_numpy(b).tolist() == [5, 6, 7]


@pytest.mark.slow
def test_fused_proof_equals_miden_tpu_fused_proof():
    """The port's fused proof against ``miden_tpu``'s forced ``prove_fused``
    (``MIDEN_TPU_FUSED=1``, as tests/test_fused.py sets it)."""
    from miden_tpu.bench_airs import miden_shaped_statement as j_shaped
    from miden_tpu.stark.proof_io import proof_to_bytes as j_proof_to_bytes
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.stark.prover import prove as j_prove
    from miden_tpu.transcript.challenger import DuplexChallenger as JDuplexChallenger

    os.environ["MIDEN_TPU_FUSED"] = "1"
    try:
        j_statement, j_traces = j_shaped(6)
        j_out = j_prove(J_TEST_PARAMS, j_statement, j_traces, JDuplexChallenger(SEED))
    finally:
        os.environ.pop("MIDEN_TPU_FUSED", None)
    statement, traces = _shaped(6)
    out = prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=True)
    assert proof_to_bytes(out.proof) == j_proof_to_bytes(j_out.proof)
    assert out.digest == j_out.digest
