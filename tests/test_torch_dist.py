"""miden_tpu_torch.dist ≡ miden_tpu.dist (exact), on gloo ranks of the CPU.

The port's sharded LDE, tree and prover run in processes spawned once per
case group (``miden_tpu_torch.dist.mesh.run_ranks``, one thread each); the
rank side lives in tests/torch_dist_ranks.py and imports the port alone.
``miden_tpu`` runs here, in the parent, on the 8-virtual-device CPU mesh of
tests/conftest.py, while the ranks work. Inputs are numpy u64 from seeds;
all arithmetic is exact Goldilocks, so every comparison is equality.
"""

import multiprocessing
import threading
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from miden_tpu.field.goldilocks import fp_from_u64, fp_to_u64
from miden_tpu_torch.dist import active_mesh, make_mesh, use_mesh
from miden_tpu_torch.dist.mesh import run_ranks
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.merkle import lmcs
from miden_tpu_torch.ntt import ntt
from miden_tpu_torch.stark.prover import commit_traces

SEED = R.SEED


class _Background:
    """``fn(*args)`` in a thread; :meth:`result` joins it and re-raises."""

    def __init__(self, fn, *args):
        self._box = {}
        self._thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self._thread.start()

    def _run(self, fn, args):
        try:
            self._box["value"] = fn(*args)
        except BaseException as exc:  # handed to the test that reads it
            self._box["error"] = exc

    def result(self):
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box["value"]


def jax_proof_bytes() -> tuple:
    """miden_tpu's proof of ``miden_shaped_statement(6)`` at ``TEST_PARAMS``
    (as tests/test_torch_prove.py makes it): its bytes and digest."""
    from miden_tpu import bench_airs as JB
    from miden_tpu.stark import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.stark import prover as JPR
    from miden_tpu.stark.proof_io import proof_to_bytes as j_proof_to_bytes
    from miden_tpu.transcript import challenger as JC

    statement, traces = JB.miden_shaped_statement(6)
    out = JPR.prove(J_TEST_PARAMS, statement, traces, JC.DuplexChallenger(SEED))
    return j_proof_to_bytes(out.proof), out.digest


@pytest.fixture(scope="module")
def work():
    """The 8 ranks of every non-slow case, and miden_tpu's proof in a
    process of its own (its ~90 s of tracing and XLA compile would hold
    this process's interpreter lock against the JAX references here), all
    started at once."""
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    yield {"ranks": _Background(run_ranks, 8, R.sharded_checks), "jax_proof": pool.submit(jax_proof_bytes)}
    pool.shutdown(cancel_futures=True)


@pytest.fixture(scope="module")
def ranks(work):
    return work["ranks"].result()


# -- coset LDE ------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(R.LDE_CASES)), ids=["10-3", "12-1", "10-2-nested"])
def test_coset_lde_sharded_matches_miden_tpu_on_8(work, case):
    from miden_tpu.dist import make_mesh as j_make_mesh
    from miden_tpu.dist.ntt_dist import coset_lde_sharded as j_coset_lde_sharded

    log_n, added, _, _, s_in, s_out = R.LDE_CASES[case]
    want = np.asarray(fp_to_u64(
        j_coset_lde_sharded(fp_from_u64(R.lde_input(R.LDE_CASES[case])), added, s_out, j_make_mesh(8), shift_in=s_in)
    ))
    blocks = [r["lde"][8][case] for r in work["ranks"].result()]
    rows = want.shape[0] // 8
    for k, block in enumerate(blocks):
        np.testing.assert_array_equal(block, want[k * rows : (k + 1) * rows], err_msg=f"rank {k}")


@pytest.mark.parametrize("d", [2, 4])
def test_coset_lde_sharded_matches_single_device(ranks, d):
    for case, c in enumerate(R.LDE_CASES):
        want = F.to_numpy(ntt.coset_lde(F.to_torch(R.lde_input(c), "cpu"), c[1], c[5], shift_in=c[4]))
        got = np.concatenate([ranks[k]["lde"][d][case] for k in range(d)])
        np.testing.assert_array_equal(got, want, err_msg=f"case {c[:2]}")


# -- LMCS tree --------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tree():
    from miden_tpu.dist import make_mesh as j_make_mesh
    from miden_tpu.dist.lmcs_dist import build_tree_sharded as j_build_tree_sharded

    return j_build_tree_sharded([fp_from_u64(m) for m in R.tree_inputs()], j_make_mesh(8))


def test_tree_sharded_layers_match_miden_tpu_on_8(ranks, jax_tree):
    want = [np.asarray(fp_to_u64(layer)) for layer in jax_tree.layers]
    single = lmcs.build_tree([F.to_torch(m, "cpu") for m in R.tree_inputs()])
    assert len(want) == len(single.layers) == 10
    for k, r in enumerate(ranks):
        assert len(r["tree_layers"]) == len(want)
        for j, (got, layer) in enumerate(zip(r["tree_layers"], want)):
            np.testing.assert_array_equal(got, layer, err_msg=f"rank {k}, layer {j}")
            np.testing.assert_array_equal(got, F.to_numpy(single.layers[j]), err_msg=f"rank {k}, layer {j}")


def test_tree_sharded_openings_match_miden_tpu(ranks, jax_tree):
    """The port's query gather over the sharded tree, emitted as hints,
    equals ``gather_openings_dev`` of miden_tpu's sharded tree: the aligned
    rows per index, then the sibling digests of the schedule."""
    from miden_tpu.merkle import lmcs as JL

    flat, meta = JL.gather_openings_dev(jax_tree, R.OPEN_INDICES)
    want = [int(v) for v in np.asarray(fp_to_u64(flat))]
    for k, r in enumerate(ranks):
        fields, digests = r["tree_hints"]
        assert len(digests) == meta[2]
        assert fields + [v for d in digests for v in d] == want, f"rank {k}"


def test_commit_hook_matches_single_device(ranks):
    """commit_traces under a 2-rank mesh: a sharded LDE and tree under
    poseidon2; a sharded LDE, gathered, under a tree of rpo256."""
    traces = [F.to_torch(m, "cpu") for m in R.commit_inputs()]
    for name, cfg in (("poseidon2", lmcs.POSEIDON2_HASH), ("rpo256", lmcs.RPO_HASH)):
        want = commit_traces(traces, 2, hash=cfg).root()
        for k in range(2):
            np.testing.assert_array_equal(ranks[k]["commit_roots"][name], want, err_msg=f"{name}, rank {k}")


# -- prove_sharded ------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_proof():
    from miden_tpu_torch.bench_airs import miden_shaped_statement
    from miden_tpu_torch.stark import TEST_PARAMS, prove
    from miden_tpu_torch.transcript import challenger as C

    statement, traces = miden_shaped_statement(6, device="cpu")
    return prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu")


def test_prove_sharded_bytes_equal_single_device_and_miden_tpu(work, ranks, port_proof):
    from miden_tpu_torch.stark.proof_io import proof_to_bytes

    single = proof_to_bytes(port_proof.proof)
    jax_bytes, jax_digest = work["jax_proof"].result()
    assert jax_bytes == single
    assert len(ranks) == 8
    for k in range(8):
        got, digest = ranks[k]["proof"]
        assert got == single, f"rank {k}"
        assert digest == port_proof.digest == jax_digest


def test_prove_sharded_fused_on_cpu_ranks_gives_the_same_bytes(ranks, port_proof):
    """``fused=True`` under the gloo mesh on the CPU runs the plan's phases
    eagerly on every rank: the same bytes."""
    from miden_tpu_torch.stark.proof_io import proof_to_bytes

    single = proof_to_bytes(port_proof.proof)
    for k, r in enumerate(ranks):
        assert r["fused_proof"] == single, f"rank {k}"


def test_prove_sharded_keeps_every_max_height_tensor_row_sharded(ranks):
    """After ``stage_open`` each of the 8 ranks holds every max-height
    matrix, every tree layer below the top log2 8 and the first FRI layers
    of the main, aux, quotient and FRI trees as a RowShard of N/8 rows:
    1/8 of one device's bytes of them."""
    for k, r in enumerate(ranks):
        held = r["held"]
        assert held["not_sharded"] == [], f"rank {k}: {held['not_sharded']}"
        assert held["local"] * 8 == held["whole"] > 0, f"rank {k}: {held}"


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("check", R.STAGE_CHECKS)
def test_sharded_stage_equals_single_device(ranks, check, d):
    """Each sharded piece (tests/torch_dist_ranks.py ``stage_checks``) is its
    one-device function's result, bit for bit, on every rank of a mesh of
    ``d``."""
    for k in range(d):
        assert ranks[k]["stages"][d][check], f"{check} on rank {k} of {d}"


def test_preprocessed_statement_under_a_mesh_equals_single_device(ranks):
    """The square-LUT statement (its preprocessed tree whole on every rank,
    read by the sharded quotient at this rank's rows) proved under a mesh of
    2 equals the single-device proof."""
    from miden_tpu_torch.bench_airs import square_lut_statement
    from miden_tpu_torch.stark import TEST_PARAMS, build_preprocessed, prove
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.transcript import challenger as C

    statement, traces = square_lut_statement(R.STAGE_LOG_N, device="cpu")
    pp = build_preprocessed(statement, TEST_PARAMS, device="cpu")
    want = proof_to_bytes(prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), preprocessed=pp,
                                device="cpu").proof)
    assert [r["preprocessed_proof"] for r in ranks[:2]] == [want, want]


@pytest.mark.parametrize("backend,device,fused,want", [
    ("gloo", "cuda", None, False), ("gloo", "cuda", False, False), ("gloo", "cuda", True, "raises"),
    ("gloo", "cpu", None, False), ("gloo", "cpu", True, True), ("nccl", "cuda", None, True),
    ("nccl", "cuda", False, False),
])
def test_use_fused_under_a_mesh(backend, device, fused, want):
    """Under an NCCL mesh on the card the fused phases are the default (they
    capture the NCCL collectives); under a gloo mesh on the card they never
    run (its collectives go through host memory) and asking for them
    raises; on the CPU a gloo mesh runs them eagerly when asked."""
    from types import SimpleNamespace

    from miden_tpu_torch.stark.fused import use_fused

    with use_mesh(SimpleNamespace(backend=backend)):
        if want == "raises":
            with pytest.raises(ValueError, match="gloo mesh"):
                use_fused(device, fused)
        else:
            assert use_fused(device, fused) is want


def test_both_verifiers_accept_prove_sharded(ranks):
    from miden_tpu import bench_airs as JB
    from miden_tpu.stark import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.stark import verify as j_verify
    from miden_tpu.stark.proof_io import proof_from_bytes as j_proof_from_bytes
    from miden_tpu.transcript import challenger as JC
    from miden_tpu_torch.bench_airs import miden_shaped_statement
    from miden_tpu_torch.stark import TEST_PARAMS, verify
    from miden_tpu_torch.stark.proof_io import proof_from_bytes
    from miden_tpu_torch.transcript import challenger as C

    data, digest = ranks[0]["proof"]
    statement, _ = miden_shaped_statement(6, device="cpu")
    assert verify(TEST_PARAMS, statement, proof_from_bytes(data), C.DuplexChallenger(SEED)) == digest
    jstatement, _ = JB.miden_shaped_statement(6)
    assert j_verify(J_TEST_PARAMS, jstatement, j_proof_from_bytes(data), JC.DuplexChallenger(SEED)) == digest


def test_replicate_broadcasts_rank_0(ranks):
    for r in ranks:
        assert r["replicated"].tolist() == [100] * 3


def test_bench_commit_check_holds_on_cpu_ranks(ranks):
    """The sharded commit check chip_smoke phase 12d's ranks run on the card
    (every rank's LDE rows, layers and matrices, the sharded ones gathered,
    against one device), here at a small size."""
    for k, r in enumerate(ranks):
        assert r["bench_commit"] == {"rows_equal": True, "layers_equal": True, "matrices_equal": True}, k


def test_ranks_exchanged_and_gathered(ranks):
    """Every rank of the 8-rank mesh sent blocks in the cross stages and
    gathered the others' rows, and moved bytes through every collective of
    the sharded stages."""
    for k, r in enumerate(ranks):
        assert r["traffic"]["exchange"] > 0 and r["traffic"]["gather"] > 0, f"rank {k}: {r['traffic']}"
        assert all(r["traffic"][key] > 0 for key in ("halo", "all_to_all", "partials", "gather_at")), k


# -- no silent CPU; the context --------------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_make_mesh_without_a_card_raises():
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh("cuda")
    assert not dist.is_initialized()


def test_use_mesh_nests_and_restores():
    assert active_mesh() is None
    with use_mesh("outer"):
        with use_mesh("inner") as m:
            assert m == "inner" and active_mesh() == "inner"
        assert active_mesh() == "outer"
    assert active_mesh() is None


# -- slow -----------------------------------------------------------------------------------


@pytest.mark.slow
def test_prove_sharded_fib_product_matches_miden_tpu_on_8():
    """tests/test_dist.py's sharded proof (Fib 2^10 + ProductAir 2^7, mixed
    heights and a LogUp-style aux column) on 8 ranks, against
    miden_tpu.dist.prover.prove_sharded on the 8-device mesh. Slow: the JAX
    side alone takes ~8 minutes."""
    from miden_tpu.dist import make_mesh as j_make_mesh
    from miden_tpu.dist.prover import prove_sharded as j_prove_sharded
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.stark.proof_io import proof_to_bytes as j_proof_to_bytes
    from miden_tpu.stark.prover import MultiAir as JMultiAir
    from miden_tpu.stark.prover import Statement as JStatement
    from miden_tpu.transcript.challenger import DuplexChallenger as JDuplexChallenger
    from test_stark_e2e import FibAir as JFibAir
    from test_stark_e2e import ProductAir as JProductAir

    job = _Background(run_ranks, 8, R.fib_product_proof)
    statement, traces = R.fib_product_statement()
    jst = JStatement(JMultiAir([JFibAir(), JProductAir()]), statement.publics)
    want = j_prove_sharded(J_TEST_PARAMS, jst, traces, JDuplexChallenger(SEED), j_make_mesh(8))
    for k, (data, digest) in enumerate(job.result()):
        assert data == j_proof_to_bytes(want.proof), f"rank {k}"
        assert digest == want.digest


@pytest.mark.slow
def test_prove_program_under_use_mesh_on_2():
    """The VM fib program through prove_program under use_mesh on 2 ranks
    equals the port's single-device proof."""
    from miden_tpu_torch.stark import TEST_PARAMS
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import prove_program

    got = run_ranks(2, R.vm_fib_proof)
    _, want = prove_program(assemble(R.VM_FIB), params=TEST_PARAMS, device="cpu")
    assert got == [want.to_bytes()] * 2


def test_ranks_load_kernels_but_never_build_them(tmp_path, monkeypatch):
    """A rank started after its parent built the kernels only loads them:
    with no library built, ``load_built`` raises instead of running nvcc."""
    from miden_tpu_torch.utils import cuda

    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda, "_libs", {})
    with pytest.raises(cuda.KernelError, match="missing or stale"):
        cuda.load_built()
