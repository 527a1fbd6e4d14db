"""The port's in-VM STARK verifier ≡ ``miden_tpu``'s, on the CPU.

The seven verifier modules (``stark/*``, ``pcs::fri::frie2f4``,
``sys::vm::constraints_eval``), ``stdlib/recursion.py`` and the programs of
``miden_tpu_torch.bench_recursion``. Proofs are made by the port on the CPU
at ``TEST_PARAMS`` (no JAX proof outside ``slow``): the shaped statement of
``tests/test_recursion_masm.py`` and the ``repeat.40`` VM fib of
``tests/test_sysvm_masm.py``. Their bytes are read by both packages, and
both packages' ``extract_recursion_fixture`` must give equal fixtures. Each
program of ``tests/test_stark_masm.py``, ``test_recursion_masm.py`` and
``test_sysvm_masm.py`` runs in both packages' VMs: the stacks must equal
each other and the host's values, exactly. The unit programs are built here
from host values; the fixture programs come from ``bench_recursion``.
"""

import dataclasses
import functools
import random
import re
from pathlib import Path

import pytest
import torch

from miden_tpu.stdlib import assemble_with_stdlib as j_assemble
from miden_tpu.stdlib import stdlib_event_handlers as j_handlers
from miden_tpu.vm.processor import AdviceProvider as JAdvice
from miden_tpu.vm.processor import ExecutionError as JExecutionError
from miden_tpu.vm.processor import execute as j_execute
from miden_tpu_torch import bench_recursion as B
from miden_tpu_torch.field import gl
from miden_tpu_torch.stark import TEST_PARAMS
from miden_tpu_torch.stark.domains import LiftedDomain
from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
from miden_tpu_torch.stdlib.recursion import extract_recursion_fixture
from miden_tpu_torch.transcript.challenger import DuplexChallenger
from miden_tpu_torch.vm.processor import AdviceProvider, ExecutionError, execute

COIN_SEED = [0x6D69_6465, 0x6E2D_7470, 0x752D_766D, 0x0000_0001]  # tests/test_stark_masm.py
SHAPED_SEED = [11, 22, 33, 44]  # tests/test_recursion_masm.py
FIB_40 = "begin push.0 push.1 repeat.40 swap dup.1 add end swap drop swap drop end"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU's cores; this module's torch
    work is small-tensor dispatch, as fast on one thread, and on eight it
    oversubscribes the cores the other workers use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_both(src: str, advice=None):
    """Execute ``src`` in the port's VM and in ``miden_tpu``'s: both stacks,
    which must be equal."""
    mine = execute(assemble_with_stdlib(src), [], advice=AdviceProvider(stack=list(advice or [])),
                   event_handlers=stdlib_event_handlers())
    theirs = j_execute(j_assemble(src), [], advice=JAdvice(stack=list(advice or [])),
                       event_handlers=j_handlers())
    stack = [int(v) for v in mine.stack]
    assert stack == [int(v) for v in theirs.stack]
    assert mine.clk == theirs.clk
    return stack


def refused_by_both(src: str, advice=None) -> None:
    with pytest.raises(ExecutionError):
        execute(assemble_with_stdlib(src), [], advice=AdviceProvider(stack=list(advice or [])),
                event_handlers=stdlib_event_handlers())
    with pytest.raises(JExecutionError):
        j_execute(j_assemble(src), [], advice=JAdvice(stack=list(advice or [])),
                  event_handlers=j_handlers())


# ---------------------------------------------------------------------------
# the registry root the MASM pins
# ---------------------------------------------------------------------------


def test_ace_registry_root_equals_constraints_eval_constants_and_miden_tpu():
    from miden_tpu.vm.ace_registry import registry_root as j_registry_root
    from miden_tpu_torch.vm.ace_registry import registry_root

    path = Path(B.__file__).parent / "stdlib" / "asm" / "sys" / "vm" / "constraints_eval.masm"
    consts = dict(re.findall(r"^const (REGISTRY_ROOT\d) = (\d+)$", path.read_text(), re.M))
    pinned = tuple(int(consts[f"REGISTRY_ROOT{i}"]) for i in range(4))
    assert tuple(int(v) for v in registry_root()) == pinned
    assert tuple(int(v) for v in j_registry_root()) == pinned


# ---------------------------------------------------------------------------
# unit programs: random coin, public inputs (tests/test_stark_masm.py)
# ---------------------------------------------------------------------------


def _coin(body: str, uses: str = "use miden::core::stark::random_coin") -> str:
    s = COIN_SEED
    return f"""
    {uses}
    begin
        push.{s[3]}.{s[2]}.{s[1]}.{s[0]}
        exec.random_coin::init
        {body}
    end
    """


def _host(*observe) -> DuplexChallenger:
    host = DuplexChallenger(COIN_SEED)
    host.observe_slice(list(observe))
    return host


@functools.lru_cache(maxsize=1)
def _coin_cases():
    cases = {}
    host = _host()
    want = [host.sample() for _ in range(3)]
    cases["init_and_first_samples"] = (
        _coin("exec.random_coin::sample_felt " * 3), want[::-1])
    host = _host(11, 22, 33)
    cases["observe_partial_buffer"] = (
        _coin(" ".join(f"push.{v} exec.random_coin::observe_felt" for v in (11, 22, 33))
              + " exec.random_coin::sample_felt"), [host.sample()])
    vals = list(range(100, 111))
    host = _host(*vals)
    w = [host.sample(), host.sample()]
    cases["observe_across_rate_boundary"] = (
        _coin(" ".join(f"push.{v} exec.random_coin::observe_felt" for v in vals)
              + " exec.random_coin::sample_felt exec.random_coin::sample_felt"), w[::-1])
    host = _host(7)
    s1 = host.sample()
    host.observe(9)
    cases["interleaved_observe_sample"] = (
        _coin("push.7 exec.random_coin::observe_felt exec.random_coin::sample_felt "
              "push.9 exec.random_coin::observe_felt exec.random_coin::sample_felt"), [host.sample(), s1])
    host = _host(5)
    c0, c1 = host.sample_ext()
    cases["sample_ext_and_bits"] = (
        _coin("push.5 exec.random_coin::observe_felt exec.random_coin::sample_ext "
              "push.16 exec.random_coin::sample_bits"), [host.sample_bits(16), c0, c1])
    vals = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    stores = " ".join(f"push.{v} push.{1000 + i} mem_store" for i, v in enumerate(vals))
    cases["observe_mem"] = (
        _coin(f"{stores} push.{len(vals)} push.1000 exec.random_coin::observe_mem "
              "exec.random_coin::sample_felt"), [_host(*vals).sample()])
    publics, log_heights = [7, 0, 3, 9, 2, 5], [14, 12, 10]
    stores = " ".join(f"push.{v} push.{2000 + i} mem_store" for i, v in enumerate(publics))
    stores += " " + " ".join(f"push.{v} push.{3000 + i} mem_store" for i, v in enumerate(log_heights))
    cases["public_inputs_binding"] = (
        _coin(f"{stores} push.{len(publics)} push.2000 exec.public_inputs::observe_publics "
              f"push.3000 push.{len(log_heights)} exec.public_inputs::observe_shape "
              "exec.random_coin::sample_felt",
              "use miden::core::stark::public_inputs\n    use miden::core::stark::random_coin"),
        [_host(*publics, len(log_heights), *log_heights).sample()])
    host = _host(42)
    witness = host.grind(4, device="cpu")
    s = COIN_SEED
    cases["check_witness_accepts_host_grind"] = (f"""
    use miden::core::stark::random_coin
    begin
        push.42 push.4 push.{witness}
        push.{s[3]}.{s[2]}.{s[1]}.{s[0]}
        exec.random_coin::init
        movup.2 exec.random_coin::observe_felt
        exec.random_coin::check_witness
    end
    """, [])
    return cases


COIN_CASES = [
    "check_witness_accepts_host_grind", "init_and_first_samples", "interleaved_observe_sample",
    "observe_across_rate_boundary", "observe_mem", "observe_partial_buffer", "public_inputs_binding",
    "sample_ext_and_bits",
]


@pytest.mark.parametrize("name", COIN_CASES)
def test_random_coin_program_equals_miden_tpu_and_host(name):
    src, want = _coin_cases()[name]
    assert run_both(src)[: len(want)] == want


def test_check_witness_rejects_a_bad_witness_in_both():
    refused_by_both(_coin("push.12 push.1234567 exec.random_coin::check_witness"))


# ---------------------------------------------------------------------------
# unit programs: ood_frames, deep_queries (tests/test_recursion_masm.py)
# ---------------------------------------------------------------------------


def _unit_cases():
    cases = {}
    vals = [(3 * i + 1, 7 * i + 2) for i in range(8)]
    alpha = (12345, 67890)
    acc = (0, 0)
    for v in vals:
        acc = gl.ext_add(gl.ext_mul(acc, alpha), v)
    stores = " ".join(f"push.{c} push.{1000 + 2 * i + j} mem_store"
                      for i, v in enumerate(vals) for j, c in enumerate(v))
    cases["horner_ext_mem"] = (f"""
    use miden::core::stark::ood_frames
    begin
        {stores}
        push.{alpha[0]} push.2000 mem_store push.{alpha[1]} push.2001 mem_store
        push.2000 push.8 push.1000
        exec.ood_frames::horner_ext_mem
    end
    """, None, list(acc))
    base = [5 * i + 3 for i in range(16)]
    alpha = (999, 888)
    acc = (0, 0)
    for v in base:
        acc = gl.ext_add(gl.ext_mul(acc, alpha), (v, 0))
    stores = " ".join(f"push.{v} push.{1000 + i} mem_store" for i, v in enumerate(base))
    cases["horner_base_mem"] = (f"""
    use miden::core::stark::ood_frames
    begin
        {stores}
        push.{alpha[0]} push.2000 mem_store push.{alpha[1]} push.2001 mem_store
        push.2000 push.16 push.1000
        exec.ood_frames::horner_base_mem
    end
    """, None, list(acc))
    vals = [17, 29, 31, 43, 59]
    cases["load_evals_observes_like_channel"] = (_coin(
        f"push.{len(vals)} push.5000 exec.ood_frames::load_evals "
        "exec.random_coin::sample_felt push.5002 mem_load",
        "use miden::core::stark::ood_frames\n    use miden::core::stark::random_coin",
    ), vals, [vals[2], _host(*vals).sample()])
    log_k, idx = 9, 377
    want = gl.mul(gl.canonical_lde_shift(log_k), pow(gl.two_adic_generator(log_k), idx, gl.P))
    cases["compute_x"] = (f"""
    use miden::core::stark::deep_queries
    begin push.{log_k} push.{idx} exec.deep_queries::compute_x end
    """, None, [want])
    v, k = (123456789, 987654321), 5
    cases["ext_exp_pow2"] = (f"""
    use miden::core::stark::deep_queries
    begin push.{v[1]} push.{v[0]} push.{k} exec.deep_queries::ext_exp_pow2 end
    """, None, list(gl.ext_exp_power_of_2(v, k)))
    rng = random.Random(3)
    x, h = rng.randrange(gl.P), rng.randrange(gl.P)
    z, fz0, fz1, fx, beta = [(rng.randrange(gl.P), rng.randrange(gl.P)) for _ in range(5)]
    q, bpow = (0, 0), (1, 0)
    for j, zj in enumerate([z, gl.ext_mul_base(z, h)]):
        num = gl.ext_sub([fz0, fz1][j], fx)
        q = gl.ext_add(q, gl.ext_mul(bpow, gl.ext_mul(num, gl.ext_inv(gl.ext_sub(zj, (x, 0))))))
        bpow = gl.ext_mul(bpow, beta)
    pushes = " ".join(f"push.{c}" for c in reversed([x, h, *z, *fz0, *fz1, *fx, *beta]))
    cases["deep_quotient"] = (f"""
    use miden::core::stark::deep_queries
    begin {pushes} exec.deep_queries::deep_quotient end
    """, None, list(q))
    return cases


# ---------------------------------------------------------------------------
# unit programs: sys::vm::constraints_eval (tests/test_sysvm_masm.py)
# ---------------------------------------------------------------------------


def _sysvm_cases():
    from miden_tpu_torch.hash import poseidon2_host as hp

    cases = {}
    for n in (0, 5, 8, 19, 24):
        vals = [7 * i + 3 for i in range(n)]
        stores = " ".join(f"push.{v} push.{4000 + i} mem_store" for i, v in enumerate(vals))
        cases[f"hash_felts_mem_{n}"] = (f"""
        use miden::core::sys::vm::constraints_eval
        begin
            {stores}
            push.5000 push.{n} push.4000
            exec.constraints_eval::hash_felts_mem
        end
        """, None, list(hp.hash_elements(vals)))
    z, log_h, log_lift = (123456789123, 987654321987), 6, 2
    sels = LiftedDomain(log_h, TEST_PARAMS.log_blowup, log_lift).selectors_at(z)
    cases["selectors_at"] = (f"""
    use miden::core::sys::vm::constraints_eval
    begin
        push.{log_lift} push.{log_h} push.{z[1]} push.{z[0]}
        exec.constraints_eval::selectors_at
    end
    """, None, [*sels.is_first_row, *sels.is_last_row, *sels.is_transition])
    cases["load_circuit"] = (B.LOAD_CIRCUIT_PROGRAM, B.load_circuit_advice(), [100002])
    return cases


UNIT_CASES = [
    "compute_x", "deep_quotient", "ext_exp_pow2", "horner_base_mem", "horner_ext_mem",
    "load_evals_observes_like_channel", *(f"hash_felts_mem_{n}" for n in (0, 5, 8, 19, 24)),
    "load_circuit", "selectors_at",
]


@functools.lru_cache(maxsize=1)
def _all_unit_cases():
    return {**_unit_cases(), **_sysvm_cases()}


@pytest.mark.parametrize("name", UNIT_CASES)
def test_verifier_procedure_equals_miden_tpu_and_host(name):
    src, advice, want = _all_unit_cases()[name]
    assert run_both(src, advice)[: len(want)] == want


def test_a_tampered_circuit_blob_is_refused_by_both():
    refused_by_both(B.LOAD_CIRCUIT_PROGRAM, B.load_circuit_advice(tamper=True))


# ---------------------------------------------------------------------------
# fixtures of real proofs, made by the port on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[8, 7], ids=["shaped8", "shaped7_odd_split"])
def shaped(request):
    """The port's proof of miden_shaped_statement(log) at TEST_PARAMS and both
    packages' fixtures of its bytes. Log 8 is tests/test_recursion_masm.py's
    (log LDE 11: 6 folded bits); log 7 folds 5, an odd split."""
    from miden_tpu.bench_airs import miden_shaped_statement as j_shaped_statement
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.stark.proof_io import proof_from_bytes as j_proof_from_bytes
    from miden_tpu.stdlib.recursion import extract_recursion_fixture as j_extract
    from miden_tpu.transcript.challenger import DuplexChallenger as JDuplex
    from miden_tpu_torch.bench_airs import miden_shaped_statement
    from miden_tpu_torch.stark import prove
    from miden_tpu_torch.stark.proof_io import proof_from_bytes, proof_to_bytes

    log = request.param
    st, traces = miden_shaped_statement(log, device="cpu")
    blob = proof_to_bytes(prove(TEST_PARAMS, st, traces, DuplexChallenger(SHAPED_SEED), device="cpu").proof)
    fx = extract_recursion_fixture(TEST_PARAMS, st, proof_from_bytes(blob), DuplexChallenger(SHAPED_SEED))
    j_st, _ = j_shaped_statement(log)
    j_fx = j_extract(J_TEST_PARAMS, j_st, j_proof_from_bytes(blob), JDuplex(SHAPED_SEED))
    return log, fx, j_fx


@pytest.fixture(scope="module")
def vm():
    """The port's proof of tests/test_sysvm_masm.py's fib program at
    TEST_PARAMS: the proof, the port's statement and fixture, and
    miden_tpu's fixture of the same bytes."""
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.stdlib.recursion import extract_recursion_fixture as j_extract
    from miden_tpu.transcript.challenger import DuplexChallenger as JDuplex
    from miden_tpu.vm.prove import VmProof as JVmProof
    from miden_tpu.vm.prove import _statement as j_statement
    from miden_tpu.vm.prove import protocol_seed as j_protocol_seed
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import prove_program

    _out, proof = prove_program(assemble(FIB_40), params=TEST_PARAMS, device="cpu")
    st, fx = B.vm_recursion_fixture(proof, TEST_PARAMS)
    jp = JVmProof.from_bytes(proof.to_bytes())
    j_st = j_statement(jp.program_hash, jp.stack_inputs, jp.stack_outputs, jp.kernel_digests, jp.deferred_root)
    j_fx = j_extract(J_TEST_PARAMS, j_st, jp.stark, JDuplex(j_protocol_seed()))
    return proof, st, fx, j_fx


def _assert_fixtures_equal(fx, j_fx):
    mine, theirs = dataclasses.asdict(fx), dataclasses.asdict(j_fx)
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        assert mine[key] == theirs[key], key
    assert len(fx.indices) >= 1 and len(fx.raw_index_samples) == TEST_PARAMS.num_queries


def test_shaped_fixture_equals_miden_tpu(shaped):
    log, fx, j_fx = shaped
    _assert_fixtures_equal(fx, j_fx)
    assert fx.log_lde_height == log + TEST_PARAMS.log_blowup
    final_log = TEST_PARAMS.log_final_poly_degree + TEST_PARAMS.log_blowup
    assert len(fx.fri_betas) == -(-(fx.log_lde_height - final_log) // TEST_PARAMS.log_folding_arity)


def test_vm_fixture_equals_miden_tpu(vm):
    _proof, _st, fx, j_fx = vm
    _assert_fixtures_equal(fx, j_fx)


def test_fri_query_programs_equal_miden_tpu_at_every_index(shaped):
    """tests/test_recursion_masm.py test_fri_verify_query_on_real_proof."""
    _log, fx, _ = shaped
    for d in fx.indices:
        assert run_both(B.fri_query_program(fx, d))[0] == 1


def test_transcript_replay_equals_miden_tpu_and_the_fixture(shaped):
    """tests/test_recursion_masm.py test_deep_fri_full_transcript_replay, on
    an even and an odd fold split."""
    _log, fx, _ = shaped
    stack = run_both(B.transcript_replay_program(fx, TEST_PARAMS, SHAPED_SEED), B.replay_advice(fx))
    assert stack[:7] == [1, *fx.z, *fx.alpha_deep, *fx.beta_deep]


def test_vm_transcript_replay_equals_miden_tpu_and_the_fixture(vm):
    from miden_tpu_torch.vm.prove import protocol_seed

    _proof, _st, fx, _ = vm
    stack = run_both(B.transcript_replay_program(fx, TEST_PARAMS, protocol_seed()), B.replay_advice(fx))
    assert stack[:7] == [1, *fx.z, *fx.alpha_deep, *fx.beta_deep]


def test_replay_refuses_a_tampered_transcript(shaped):
    """One flipped felt of the opened rows breaks the DEEP / FRI chain."""
    _log, fx, _ = shaped
    adv = B.replay_advice(fx)
    adv[-1] ^= 1
    refused_by_both(B.transcript_replay_program(fx, TEST_PARAMS, SHAPED_SEED), adv)


def test_ood_identity_equals_miden_tpu(vm):
    """tests/test_sysvm_masm.py test_ood_identity_in_vm."""
    _proof, st, fx, _ = vm
    src, adv = B.ood_identity_program(st, fx, TEST_PARAMS)
    assert run_both(src, adv)[0] == 1


def test_replay_memory_map_refuses_overlap(vm):
    _proof, _st, fx, _ = vm
    many = dataclasses.replace(TEST_PARAMS, num_queries=B.OOD - B.IDX + 1)
    with pytest.raises(ValueError, match="IDX"):
        B.transcript_replay_program(fx, many, [0, 0, 0, 0])


def test_the_fri_query_program_of_miden_tpus_test_ends_at_depth_17(shaped):
    """tests/test_recursion_masm.py test_fri_query_program_proves_e2e ends its
    program with ``push.1`` over a stack of 16, so its execute_and_trace
    refuses it (the last-row boundary constraint needs depth 16): a fault of
    that slow test, pinned. bench_recursion's program ends with ``push.1
    swap drop``."""
    from miden_tpu.vm.trace import execute_and_trace as j_execute_and_trace

    _log, fx, _ = shaped
    src = B.fri_query_program(fx).replace("push.1 swap drop", "push.1")
    with pytest.raises(JExecutionError, match="depth 16, got 17"):
        j_execute_and_trace(j_assemble(src), event_handlers=j_handlers())


# ---------------------------------------------------------------------------
# proofs of the verifier programs
# ---------------------------------------------------------------------------


def test_fri_query_proof_verifies_in_both_packages(vm):
    """The port proves fri_query_program (the VM fixture's first query) on the
    CPU; both packages' verifiers accept it."""
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.vm.prove import VmProof as JVmProof
    from miden_tpu.vm.prove import verify_program as j_verify_program
    from miden_tpu_torch.vm.prove import prove_program, verify_program

    _proof, _st, fx, _ = vm
    out, proof = prove_program(assemble_with_stdlib(B.fri_query_program(fx)), params=TEST_PARAMS,
                               event_handlers=stdlib_event_handlers(), device="cpu")
    assert out.stack[0] == 1
    verify_program(proof, params=TEST_PARAMS, partial=True)
    j_verify_program(JVmProof.from_bytes(proof.to_bytes()), params=J_TEST_PARAMS, partial=True)


@pytest.mark.slow
def test_fri_query_proof_bytes_equal_miden_tpu(vm):
    """miden_tpu's JAX proof of the same program (minutes of XLA compile)."""
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.vm.prove import prove_program as j_prove_program
    from miden_tpu_torch.vm.prove import prove_program

    _proof, _st, fx, _ = vm
    src = B.fri_query_program(fx)
    _, proof = prove_program(assemble_with_stdlib(src), params=TEST_PARAMS,
                             event_handlers=stdlib_event_handlers(), device="cpu")
    _, j_proof = j_prove_program(j_assemble(src), params=J_TEST_PARAMS, event_handlers=j_handlers())
    assert proof.to_bytes() == j_proof.to_bytes()
