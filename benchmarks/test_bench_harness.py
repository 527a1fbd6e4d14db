"""CPU tests of the benchmark's harness and reference (the card's tests are
marked ``cuda`` and skip without a card).

    python -m pytest benchmarks -q

The tests that hold the reference to the port prove small fib programs on
the CPU at a small parameter set; they are the one place where a test
imports both.
"""

from __future__ import annotations

import dataclasses
import json
import random
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import reference  # noqa: E402
from benchmarks.harness import judge, spec, work  # noqa: E402
from benchmarks.harness.cell import run_cell  # noqa: E402
from benchmarks.harness.profile import Profile, busy_s, idle_gaps  # noqa: E402
from benchmarks.harness.traffic import P, Traffic  # noqa: E402

#: the small parameter set of the port's tests (``stark/params.py`` TEST_PARAMS)
SMALL = {"log_blowup": 3, "log_folding_arity": 2, "log_final_poly_degree": 2, "folding_pow_bits": 1,
         "deep_pow_bits": 2, "num_queries": 4, "query_pow_bits": 2, "hash_name": "poseidon2"}
SMALL_FIB = {"family": "fib", "repeat": 10}
BIG_SEED = 2**31 + 977


def bench() -> dict:
    return spec.load_benchmark()


def small_cell(name: str = "fib18-p2-replay", warm: int = 0, hash_name: str = "poseidon2") -> spec.Cell:
    """A cell of BENCHMARK.json cut to the small fib program and parameters."""
    cell = spec.find_cell(name)
    cell.config = {**cell.config, "program": dict(SMALL_FIB), "params": {**SMALL, "hash_name": hash_name}}
    cell.traffic = {**cell.traffic, "warm_proofs": warm}
    return cell


# -- discovery by name ------------------------------------------------------------


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = spec.find_cell(workload)
    entry = next(c for c in bench()["configs"] if c["name"] == cell.workload["config"])
    assert cell.config["name"] == entry["name"]
    assert reference.pcs_params(cell.config["params"]).hash_name == cell.config["params"]["hash_name"]
    assert reference.family(cell.config["program"]).masm(cell.config["program"]).startswith("begin")
    Traffic(cell.traffic, BIG_SEED)
    assert {"s_per_proof", "peak_mem_gib", "setup_s"} <= {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no-such-cell")


def test_benchmark_entries_name_their_files():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmarks/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        assert (ROOT / "benchmarks" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


# -- the generator ----------------------------------------------------------------


def test_seeded_inputs_repeat_for_a_seed():
    mix = spec.load_traffic("closed1-replay")
    a, b, c = Traffic(mix, BIG_SEED), Traffic(mix, BIG_SEED), Traffic(mix, BIG_SEED + 1)
    for part in ("warm", "window", "profiled"):
        for i in range(4):
            assert a.stack_inputs(part, i) == b.stack_inputs(part, i)
            assert a.stack_inputs(part, i) != c.stack_inputs(part, i)
            assert len(a.stack_inputs(part, i)) == 16 and all(0 <= v < P for v in a.stack_inputs(part, i))
    assert a.stack_inputs("window", 0) != a.stack_inputs("window", 1)
    assert a.stack_inputs("window", 0) != a.stack_inputs("warm", 0)


# -- the reference against the port ---------------------------------------------------


@pytest.fixture(scope="module", params=["poseidon2", "rpo256"])
def small_proof(request):
    """(proof bytes, stack inputs, parameters, the port's program) of the
    small fib program proved by the port on the CPU."""
    from miden_tpu_torch.stark.params import PcsParams
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import prove_program

    params = {**SMALL, "hash_name": request.param}
    program = assemble(reference.family(SMALL_FIB).masm(SMALL_FIB))
    rng = random.Random(BIG_SEED)
    inputs = [rng.randrange(P) for _ in range(16)]
    _, proof = prove_program(program, inputs, params=PcsParams(**params), device="cpu")
    return proof.to_bytes(), inputs, params, program, proof


def test_reference_program_hash_and_outputs_equal_the_ports(small_proof):
    _, inputs, _, program, proof = small_proof
    fam = reference.family(SMALL_FIB)
    assert fam.program_hash(SMALL_FIB) == tuple(program.hash)
    assert fam.stack_outputs(SMALL_FIB, inputs) == list(proof.stack_outputs)


def test_reference_accepts_the_ports_proof(small_proof):
    data, inputs, params, _, _ = small_proof
    v = reference.judge(data, SMALL_FIB, params, inputs)
    assert v == {"inputs_wrong": 0, "outputs_wrong": 0, "hash_wrong": 0, "rejected": 0, "why": ""}


def _flip(data: bytes, at: int) -> bytes:
    out = bytearray(data)
    out[at] ^= 0x01
    return bytes(out)


#: byte offsets in an execution proof: magic and version (8), program hash
#: (32), deferred root (32), stack inputs (128), then the stack outputs
OUTPUTS_AT = 8 + 32 + 32 + 128


def test_reference_rejects_a_flipped_byte(small_proof):
    data, inputs, params, _, _ = small_proof
    for at in (len(data) // 2, len(data) - 40, OUTPUTS_AT + 128 + 40):
        assert reference.judge(_flip(data, at), SMALL_FIB, params, inputs)["rejected"] == 1


def test_reference_rejects_a_wrong_stack_output(small_proof):
    data, inputs, params, _, _ = small_proof
    v = reference.judge(_flip(data, OUTPUTS_AT), SMALL_FIB, params, inputs)
    assert v["outputs_wrong"] == 1 and v["rejected"] == 1 and v["inputs_wrong"] == 0


def test_reference_rejects_a_proof_of_other_inputs(small_proof):
    data, inputs, params, _, _ = small_proof
    v = reference.judge(data, SMALL_FIB, params, [inputs[1], inputs[0], *inputs[2:]])
    assert v["inputs_wrong"] == 1 and v["rejected"] == 1


def test_reference_rejects_the_other_hash(small_proof):
    data, inputs, params, _, _ = small_proof
    other = {**params, "hash_name": "rpo256" if params["hash_name"] == "poseidon2" else "poseidon2"}
    assert reference.judge(data, SMALL_FIB, other, inputs)["rejected"] == 1


def test_reference_rejects_one_query_fewer(small_proof):
    """The control at a small size: the port's proof with one query fewer
    than the parameters state is refused at those parameters."""
    from benchmarks.control import weaker
    from miden_tpu_torch.stark.params import PcsParams
    from miden_tpu_torch.vm.prove import prove_program

    _, inputs, params, program, _ = small_proof
    _, proof = prove_program(program, inputs, params=weaker(PcsParams(**params)), device="cpu")
    v = reference.judge(proof.to_bytes(), SMALL_FIB, params, inputs)
    assert v["rejected"] == 1 and v["outputs_wrong"] == 0


# -- a run with the timed path broken underneath -------------------------------------------


def test_sound_run_is_correct():
    r = run_cell(small_cell(warm=1), BIG_SEED, 0, False, device="cpu", workers=1)
    assert r["correct"] and r["attempted"] == 1 and r["failed"] == 0
    assert r["run"]["judged"] == 2 and set(r["metrics"]) == {"s_per_proof", "setup_s"}


def _broken(fault: str):
    from miden_tpu_torch.vm.prove import prove_program

    first = []

    def prove(program, inputs, params):
        out, proof = prove_program(program, inputs, params=params, device="cpu")
        if fault == "state unchanged":  # every proof after the first is the first again
            first.append((out, proof))
            return first[0]
        if fault == "answer altered":  # the claimed output is changed where it is made
            proof.stack_outputs = [(proof.stack_outputs[0] + 1) % P, *proof.stack_outputs[1:]]
            return out, proof
        if fault == "control":
            from benchmarks.control import weaker

            return prove_program(program, inputs, params=weaker(params), device="cpu")
        raise ValueError(fault)

    return prove


@pytest.mark.parametrize("fault", ["state unchanged", "answer altered", "control"])
def test_broken_prover_is_not_correct(fault):
    r = run_cell(small_cell(warm=1), BIG_SEED, 0, False, device="cpu", prove=_broken(fault), workers=1)
    assert not r["correct"] and r["failed"] == 1
    assert r["checks"]["rejected"]["value"] >= 1


def test_a_prover_that_raises_is_not_correct():
    def prove(program, inputs, params):
        raise RuntimeError("no proof")

    r = run_cell(small_cell(), BIG_SEED, 0, False, device="cpu", prove=prove, workers=1)
    assert not r["correct"] and r["checks"]["missing"]["value"] == 1


def test_traced_run_reads_the_spans():
    r = run_cell(small_cell(), BIG_SEED, 0, True, device="cpu", workers=1)
    assert r["correct"]
    assert r["metrics"]["trace_s"]["value"] > 0 and r["metrics"]["prover_s"]["value"] > 0
    # the device metrics have nothing to read on the CPU and are left out
    assert not {"kernel_s", "torch_kernel_s", "kernels_roofline", "device_idle_pct"} & set(r["metrics"])


# -- the frozen arithmetic ----------------------------------------------------------------


@pytest.mark.parametrize("name,key", [
    ("ntt_col_transform", (10, 8, True, False)),
    ("ntt_transpose_twiddle", (4, 8, 3, 1)),
    ("ntt_transpose_twiddle", (4, 8, 3, 0)),
    ("poseidon2_permute", (8,)),
    ("poseidon2_absorb_rows", (64, 32, 51)),
    ("poseidon2_compress_rows", (16,)),
    ("rpo_absorb_rows", (64, 16, 12)),
    ("rpo_compress_rows", (16,)),
    ("rpx_permute", (8,)),
])
def test_roofline_work_equals_bench_kernels(name, key):
    import torch

    from miden_tpu_torch import bench_kernels as bk
    from miden_tpu_torch.hash import poseidon2, rescue
    from miden_tpu_torch.ntt import ntt

    sponges = {"poseidon2": poseidon2, "rpo": rescue.RPO, "rpx": rescue.RPX}
    case = bk.bench_case(ntt, sponges, lambda shape: torch.zeros(shape, dtype=torch.int64), name, key)
    assert spec.work_of(name, key) == (case["bytes"], case["ops"])
    assert work.INT32_MULS_PER_PERM == bk.INT32_MULS_PER_PERM


@pytest.mark.parametrize("air_name", ["CoreVmAir", "ChipletsVmAir", "Poseidon2PermutationAir"])
def test_q1_work_equals_bench_quotient(air_name):
    import torch

    from miden_tpu_torch import bench_quotient as bq
    from miden_tpu_torch.stark import interp
    from miden_tpu_torch.vm import constraints
    from miden_tpu_torch.vm.constraints import chiplets_air, poseidon2_air

    air = {"CoreVmAir": constraints.CoreVmAir, "ChipletsVmAir": chiplets_air.ChipletsVmAir,
           "Poseidon2PermutationAir": poseidon2_air.Poseidon2PermutationAir}[air_name]()
    prog = interp.get_program(air, 40, air.num_randomness, air.num_aux_values)
    nd = 1 << 12
    empty = lambda *shape: torch.empty(shape, dtype=torch.int64)  # noqa: E731
    inp = types.SimpleNamespace(
        nd=nd, scal=empty(prog.n_fixed - prog.n_vec),
        sources=(empty(nd, air.width), empty(nd, air.preprocessed_width) if air.preprocessed_width else None,
                 empty(nd, 2 * air.aux_width) if air.aux_width else None,
                 empty(3 + len(air.periodic_columns), nd)))
    assert spec.work_of("constraints_eval", (air_name, nd)) == bq.program_work(prog, inp)
    assert spec.work_of("constraints_eval", (air_name, nd, "halo")) == bq.program_work(prog, inp)


def test_bounds_use_the_published_bandwidth():
    from miden_tpu_torch import bench_kernels as bk

    from benchmarks.harness import peaks

    assert peaks.HBM_BYTES_PER_S == bk.HBM_BYTES_PER_S
    rates = {"hbm_bytes_per_s": peaks.HBM_BYTES_PER_S, "int32_muls_per_s": 1e12}
    assert peaks.bound_s(3.35e9, 1, rates) == pytest.approx(1e-3)
    assert peaks.bound_s(0, 2e9, rates) == pytest.approx(2e-3)


# -- the readers ------------------------------------------------------------------------


def _ctx(profile, launches, work_of=None):
    return {"proofs": 2, "spans": {}, "profile": profile, "launches": launches,
            "kernel_of": lambda name: "k3" if "permute_kernel" in name else None,
            "work_of": work_of or (lambda kernel, key: (0, 10**9)),
            "peaks": {"hbm_bytes_per_s": 1e12, "int32_muls_per_s": 1e12}}


def test_readers_on_a_synthetic_profile():
    ms = 1_000_000
    p = Profile(0, 10 * ms, 1, device=[
        (0, 2 * ms, "void permute_kernel<Poseidon2>(unsigned long const*)", "kernel"),
        (1 * ms, 3 * ms, "at::native::vectorized_elementwise_kernel", "kernel"),
        (5 * ms, 6 * ms, "Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ], host=[(3 * ms, 5 * ms, "aten::cat"), (3 * ms, 9 * ms, "python"), (6 * ms, 10 * ms, "cudaGraphLaunch")])
    ctx = _ctx(p, {"k3": {(8,): 1}})
    read = lambda name: spec.metric_reader(name)(ctx)  # noqa: E731
    assert busy_s(p) == pytest.approx(4e-3)
    assert read("device_idle_pct") == pytest.approx(60.0)
    assert read("kernel_s") == pytest.approx(2e-3)
    assert read("torch_kernel_s") == pytest.approx(2e-3)
    assert read("kernels_roofline") == pytest.approx(50.0)  # 1 ms of bound in 2 ms
    assert idle_gaps(p) == [["cudaGraphLaunch", pytest.approx(4e-3)], ["aten::cat", pytest.approx(2e-3)]]
    # launches that the profile does not hold as often as the proofs launched them: nothing to read
    assert spec.metric_reader("kernels_roofline")(_ctx(p, {"k3": {(8,): 2}})) is None
    assert spec.metric_reader("kernels_roofline")(_ctx(None, {"k3": {(8,): 1}})) is None


def test_span_readers():
    ctx = {"proofs": 4, "spans": {"execute and trace": [2.0, 4], "fused phase: main": [1.0, 4],
                                  "fused phase: open": [3.0, 4], "DEEP grind": [9.0, 4]}}
    assert spec.metric_reader("trace_s")(ctx) == pytest.approx(0.5)
    assert spec.metric_reader("prover_s")(ctx) == pytest.approx(1.0)
    assert spec.metric_reader("trace_s")({"proofs": 4, "spans": {}}) is None


# -- the command --------------------------------------------------------------------------


def test_command_without_a_card_prints_no_result(tmp_path):
    r = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "run.py"), "--workload", "fib18-p2-replay",
                        "--seed", str(BIG_SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "run.py"), "--workload", workload,
                        "--seed", str(BIG_SEED), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"


def test_judge_flags_are_the_checks():
    assert set(judge.LIMITS) == {"missing", *judge.FLAGS}
    assert all(v == 0 for v in judge.LIMITS.values())


def test_control_weakens_only_the_queries():
    from benchmarks.control import weaker
    from miden_tpu_torch.stark.params import MIDEN_PARAMS

    w = weaker(MIDEN_PARAMS)
    assert w.num_queries == MIDEN_PARAMS.num_queries - 1
    assert dataclasses.replace(w, num_queries=MIDEN_PARAMS.num_queries) == MIDEN_PARAMS
