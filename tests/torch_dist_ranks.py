"""Rank side of tests/test_torch_dist.py.

Each function runs in every process of a gloo group spawned by
:func:`miden_tpu_torch.dist.mesh.run_ranks` and imports the port alone (no
JAX, no ``miden_tpu``). Inputs are numpy u64 drawn from seeds here and in
the test's parent; results go back as numpy u64 or bytes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from miden_tpu_torch import bench_dist
from miden_tpu_torch.dist import make_mesh, replicate, use_mesh
from miden_tpu_torch.dist.lmcs_dist import build_tree_sharded
from miden_tpu_torch.dist.ntt_dist import coset_lde_sharded
from miden_tpu_torch.dist import mesh as M
from miden_tpu_torch.dist import ntt_dist
from miden_tpu_torch.dist.prover import held_bytes, prove_sharded, prove_sharded_env
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.merkle import lmcs
from miden_tpu_torch.ntt import ntt
from miden_tpu_torch.stark import TEST_PARAMS, interp, pcs
from miden_tpu_torch.stark import prover as P
from miden_tpu_torch.stark.air import Air, MultiAir
from miden_tpu_torch.stark.domains import LiftedDomain, log_quotient_degree
from miden_tpu_torch.stark.proof_io import proof_to_bytes
from miden_tpu_torch.stark.prover import Statement, commit_traces
from miden_tpu_torch.transcript import challenger as C
from miden_tpu_torch.transcript.device_challenger import DeviceChallenger, DeviceProverChannel

SEED = [11, 22, 33, 44]
G = gl.GENERATOR
#: (log_n, added_bits, width, seed, shift_in, shift_out): tests/test_dist.py's cases
LDE_CASES = [(10, 3, 4, 10, 1, G), (12, 1, 4, 12, 1, G), (10, 2, 3, 7, G, gl.mul(G, G))]
#: mixed heights: one max-height, one the height of an 8-rank block, one shorter
TREE_SHAPES = [((1 << 9, 5), 1), ((1 << 6, 3), 2), ((1 << 3, 9), 3)]
OPEN_INDICES = [0, 1, 255, 511]
#: chip_smoke phase 12b's commit check at the CPU's size: (log height, width)
BENCH_SHAPES = [(7, 5), (3, 4), (6, 3)]
#: the commit hook's inputs: a max-height trace and a shorter one
COMMIT_SHAPES = [((1 << 7, 3), 21), ((1 << 4, 5), 22)]


#: the sharded stages' checks (:func:`stage_checks`), in the order they are made
STAGE_CHECKS = [
    "halo_rows", "all_to_all_rows", "sum_partials", "gather_at", "interpolate", "evaluate",
    "tree_matrices", "tree_layers", "quotient_program", "quotient_eager", "schedule_halo", "upsample",
    "accumulate", "quotient_chunks", "deep_claims", "deep_compose", "fri_rounds", "query_data",
]
#: the log trace height of the stage checks' inputs (2^9 LDE rows at TEST_PARAMS)
STAGE_LOG_N = 6


def rand_u64(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)


def rand_t(shape, seed) -> torch.Tensor:
    return F.to_torch(rand_u64(shape, seed), "cpu")


def lde_input(case) -> np.ndarray:
    log_n, _, width, seed, _, _ = case
    return rand_u64((1 << log_n, width), seed)


def tree_inputs() -> list:
    return [rand_u64(shape, seed) for shape, seed in TREE_SHAPES]


def commit_inputs() -> list:
    return [rand_u64(shape, seed) for shape, seed in COMMIT_SHAPES]


def opening_hints(tree, indices) -> tuple:
    """The batch-opening hint stream of ``tree`` at ``indices``: the fields
    (aligned rows) and the sibling digests, in transcript order."""
    ch = C.ProverChannel(C.DuplexChallenger([0, 0, 0, 0]))
    flat, meta = lmcs.gather_query_data(tree, torch.tensor(indices, dtype=torch.int64))
    lmcs.emit_opening_hints(ch, F.to_numpy(flat), meta, indices)
    return list(ch.fields), [tuple(c) for c in ch.commitments]


def _lde_blocks(mesh) -> list:
    return [
        F.to_numpy(coset_lde_sharded(F.to_torch(lde_input(c), "cpu"), c[1], c[5], mesh, shift_in=c[4]).local)
        for c in LDE_CASES
    ]


def _block(x: torch.Tensor, mesh) -> torch.Tensor:
    s = x.shape[0] // mesh.size
    return x[mesh.rank * s : (mesh.rank + 1) * s]


def _is_block(got, want: torch.Tensor, mesh) -> bool:
    """``got`` is this rank's RowShard of ``want``."""
    return isinstance(got, M.RowShard) and got.rows == want.shape[0] and torch.equal(got.local, _block(want, mesh))


def _channel(seed: int) -> DeviceProverChannel:
    return DeviceProverChannel(DeviceChallenger.from_host(C.DuplexChallenger([seed, 0, 0, 0]), "cpu"))


def _gathered(tree, mesh) -> tuple:
    return ([M.gather_rows(m, mesh) for m in tree.matrices], [M.gather_rows(x, mesh) for x in tree.layers])


def _trees_equal(sharded, whole, mesh) -> bool:
    ms, ls = _gathered(sharded, mesh)
    return len(ls) == len(whole.layers) and all(torch.equal(a, b) for a, b in zip(ms + ls, whole.matrices + whole.layers))


def _quotient_case(air, seed: int, mesh) -> tuple:
    """Random LDEs and challenges for ``air`` at 2^STAGE_LOG_N rows (its own
    max domain): the whole arguments of ``evaluate_quotient`` and the
    sharded ones (main and aux as this rank's RowShards, the preprocessed
    LDE whole)."""
    lb = TEST_PARAMS.log_blowup
    dom = LiftedDomain.canonical(STAGE_LOG_N, lb)
    big_n = dom.lde_height
    main = rand_t((big_n, air.width), seed)
    aux = rand_t((big_n, 2 * air.aux_width), seed + 1) if air.aux_width else None
    pp = rand_t((big_n, air.preprocessed_width), seed + 2) if air.preprocessed_width else None
    scal = (rand_t((2,), seed + 3), rand_t((max(air.num_public_values, 1),), seed + 4),
            rand_t((air.num_randomness, 2), seed + 5), rand_t((air.num_aux_values, 2), seed + 6))
    log_d = log_quotient_degree(air.constraint_degree())
    whole = (air, dom, main, aux, log_d, *scal, pp)
    sharded = (air, dom, M.shard_rows(main, mesh), None if aux is None else M.shard_rows(aux, mesh), log_d,
               *scal, pp, mesh)
    return whole, sharded


def stage_checks(mesh) -> dict:
    """Each sharded piece of the proof against its one-device function on
    seeded inputs, bit for bit: the collectives, the two halves of the
    sharded NTT, a sharded tree, the quotient (the plain twin of Q1 with the
    halo, its schedule reader and the eager evaluator, for an AIR with aux
    columns, one with periodic columns and one with a whole preprocessed
    LDE), the upsampling, the accumulation, the chunks, the DEEP claims and
    quotient, every FRI round (its tree, its folded layer in the next
    round's matrix, the channel's entries) and the query data. Returns
    {check: bool} over STAGE_CHECKS."""
    from miden_tpu_torch.bench_airs import CoreShapedAir, PermShapedAir, SquareLutAir

    d, k = mesh.size, mesh.rank
    out = {}
    x = rand_t((64, 3), 31)
    xs = M.shard_rows(x, mesh)
    s = 64 // d
    out["halo_rows"] = torch.equal(M.halo_rows(xs, 5, mesh), torch.roll(x, -((k + 1) * s), 0)[:5])
    out["all_to_all_rows"] = all(
        torch.equal(M.all_to_all_rows(xs, a, mesh), _block(x.reshape(a, 64 // a, 3).transpose(0, 1), mesh))
        for a in (2, 4, 8)
    )
    parts = rand_t((d, 5, 2), 32)
    out["sum_partials"] = torch.equal(M.sum_partials(parts[k], mesh), F.sum_axis0(parts))
    idx = torch.tensor([0, 63, 17, 17, 40, s - 1, s])
    out["gather_at"] = torch.equal(M.gather_at(xs, idx, mesh), x[idx])

    ev, shift = rand_t((64, 3), 33), gl.GENERATOR
    coeffs = ntt.coset_interpolate_bitrev(ev, shift)
    got = ntt_dist.coset_interpolate_bitrev_sharded(M.shard_rows(ev, mesh), shift, mesh)
    out["interpolate"] = _is_block(got, coeffs, mesh)
    out["evaluate"] = _is_block(ntt_dist.evaluate_coeffs_on_coset_sharded(got, 2, shift, mesh),
                                ntt.evaluate_coeffs_on_coset(coeffs, 2, shift), mesh)

    mats = [F.to_torch(m, "cpu") for m in tree_inputs()]
    tree, whole = build_tree_sharded(mats, mesh), lmcs.build_tree(mats)
    out["tree_matrices"] = _is_block(tree.matrices[0], mats[0], mesh) and all(
        torch.equal(a, b) for a, b in zip(tree.matrices[1:], mats[1:]))
    out["tree_layers"] = all(
        _is_block(got, want, mesh) if want.shape[0] >= d else torch.equal(got, want)
        for got, want in zip(tree.layers, whole.layers)
    ) and len(tree.layers) == len(whole.layers)

    qp = qe = sched = True
    for air, seed in ((CoreShapedAir(), 41), (PermShapedAir(), 51), (SquareLutAir(STAGE_LOG_N), 61)):
        whole_args, sharded_args = _quotient_case(air, seed, mesh)
        qp &= _is_block(P.evaluate_quotient_program(*sharded_args), P.evaluate_quotient_program(*whole_args), mesh)
        qe &= _is_block(P.evaluate_quotient_eager(*sharded_args), P.evaluate_quotient_eager(*whole_args), mesh)
        prog, inp, _ = P.quotient_program_inputs(*sharded_args)
        sched &= inp.halo is not None and torch.equal(
            interp.run_schedule_plain(prog, prog.schedule(interp.Q1_DEFAULT.on_chip), inp),
            interp.run_program_plain(prog, inp))
    out["quotient_program"], out["quotient_eager"], out["schedule_halo"] = qp, qe, sched

    lb = TEST_PARAMS.log_blowup
    dom = LiftedDomain.canonical(STAGE_LOG_N, lb)
    q = rand_t((64 << 1, 2), 71)
    out["upsample"] = _is_block(P.upsample_evals(M.shard_rows(q, mesh), dom.lde_shift, 2, mesh),
                                P.upsample_evals(q, dom.lde_shift, 2), mesh)
    acc, q8, beta = rand_t((32, 2), 72), rand_t((512, 2), 73), rand_t((2,), 74)
    out["accumulate"] = _is_block(P._accumulate_step(16, acc, M.shard_rows(q8, mesh), beta, mesh),
                                  P._accumulate_step(16, acc, q8, beta), mesh)
    acc = rand_t((64 << 3, 2), 75)
    out["quotient_chunks"] = _is_block(P._quotient_chunks_dev(M.shard_rows(acc, mesh), dom, 3, lb, mesh),
                                       P._quotient_chunks_dev(acc, dom, 3, lb), mesh)

    ldes = [rand_t((512, 5), 81), rand_t((128, 3), 82), rand_t((512, 16), 83)]
    trees_w = [lmcs.build_tree(ldes[:2]), lmcs.build_tree(ldes[2:])]
    trees_s = [build_tree_sharded([M.shard_rows(ldes[0], mesh), ldes[1]], mesh),
               build_tree_sharded([M.shard_rows(ldes[2], mesh)], mesh)]
    zs = [rand_t((2,), 84), rand_t((2,), 85)]
    claims_w, claims_s = pcs.compute_deep_claims(trees_w, zs), pcs.compute_deep_claims(trees_s, zs)
    out["deep_claims"] = all(torch.equal(a, b) for pa, pb in zip(claims_w.evals, claims_s.evals)
                             for a, b in zip(pa, pb))
    alpha, beta = rand_t((2,), 86), rand_t((2,), 87)
    deep_w = pcs.deep_compose(dom, trees_w, claims_w, zs, alpha, beta)
    deep_s = pcs.deep_compose(dom, trees_s, claims_s, zs, alpha, beta)
    out["deep_compose"] = _is_block(deep_s, deep_w, mesh)

    ch_w, ch_s = _channel(91), _channel(91)
    fri_w = pcs.fri_commit(TEST_PARAMS, dom, deep_w, ch_w)
    fri_s = pcs.fri_commit(TEST_PARAMS, dom, deep_s, ch_s, mesh)
    trees_equal = [_trees_equal(a, b, mesh) for a, b in zip(fri_s, fri_w)]  # collectives on every rank
    out["fri_rounds"] = (
        len(fri_w) == len(fri_s) and all(trees_equal) and isinstance(fri_s[0].matrices[0], M.RowShard)
        and len(ch_w._entries) == len(ch_s._entries)
        and all(a[0] == b[0] and torch.equal(a[1], b[1]) for a, b in zip(ch_w._entries, ch_s._entries))
    )
    qidx = torch.tensor([0, 511, 3, 300, 300, 64 * (d - 1) + 1])  # the same on every rank
    out["query_data"] = all([
        torch.equal(lmcs.gather_query_data(a, qidx & (a.height - 1))[0],
                    lmcs.gather_query_data(b, qidx & (b.height - 1))[0])
        for a, b in zip(trees_s + fri_s, trees_w + fri_w)
    ])
    assert list(out) == STAGE_CHECKS
    return out


def sharded_checks(rank: int) -> dict:
    """On 8 ranks: the LDE cases and the mixed-height tree on all 8, the LDE
    cases again on groups of 2 and 4, the sharded stages' checks on 8, 4
    and 2 (:func:`stage_checks`), the commit hook on 2 ranks under poseidon2
    and rpo256 and the square-LUT statement (a whole preprocessed tree) proved
    under their mesh, ``prove_sharded`` of ``miden_shaped_statement(6)`` at
    ``TEST_PARAMS`` on all 8 (eagerly, with the walk of what the stages left
    sharded, and with ``fused=True``), then a broadcast and the sharded
    commit check of ``bench_dist.lde_tree_check`` at a small size on all
    8."""
    from miden_tpu_torch.bench_airs import miden_shaped_statement, square_lut_statement
    from miden_tpu_torch.stark.preprocessed import build_preprocessed

    mesh8 = make_mesh("cpu")
    groups = {d: dist.new_group(list(range(d))) for d in (2, 4)}  # every rank joins the call
    out = {"lde": {8: _lde_blocks(mesh8)}, "stages": {8: stage_checks(mesh8)}}
    tree = build_tree_sharded([F.to_torch(m, "cpu") for m in tree_inputs()], mesh8)
    out["tree_layers"] = [F.to_numpy(M.gather_rows(layer, mesh8)) for layer in tree.layers]
    out["tree_hints"] = opening_hints(tree, OPEN_INDICES)
    for d, group in groups.items():
        if rank < d:
            mesh = make_mesh("cpu", group=group)
            out["lde"][d] = _lde_blocks(mesh)
            out["stages"][d] = stage_checks(mesh)
    if rank < 2:
        mesh2 = make_mesh("cpu", group=groups[2])
        with use_mesh(mesh2):
            traces = [F.to_torch(m, "cpu") for m in commit_inputs()]
            out["commit_roots"] = {
                name: commit_traces(traces, 2, hash=cfg).root()
                for name, cfg in (("poseidon2", lmcs.POSEIDON2_HASH), ("rpo256", lmcs.RPO_HASH))
            }
            statement, traces = square_lut_statement(STAGE_LOG_N, device="cpu")
            pp = build_preprocessed(statement, TEST_PARAMS, device="cpu")
            res = P.prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), preprocessed=pp, device="cpu")
            out["preprocessed_proof"] = proof_to_bytes(res.proof)
    statement, traces = miden_shaped_statement(6, device="cpu")
    res, env = prove_sharded_env(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), mesh8)
    out["proof"] = (proof_to_bytes(res.proof), res.digest)
    out["held"] = held_bytes(env, TEST_PARAMS, mesh8.size)
    del env
    with use_mesh(mesh8):
        res = P.prove(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), device="cpu", fused=True)
    out["fused_proof"] = proof_to_bytes(res.proof)
    out["replicated"] = F.to_numpy(replicate(torch.full((3,), 100 + rank, dtype=torch.int64), mesh8))
    out["bench_commit"] = {
        k: v for k, v in bench_dist.lde_tree_check(rank, mesh8, bench_dist.kernel_objects(), BENCH_SHAPES).items()
        if k.endswith("_equal")
    }
    out["traffic"] = dict(mesh8.traffic)
    return out


# ---------------------------------------------------------------------------
# The slow cases
# ---------------------------------------------------------------------------


class FibAir(Air):
    """tests/test_stark_e2e.py's FibAir."""

    width = 2
    num_public_values = 3

    def eval(self, f):
        a, b = f.main(0), f.main(1)
        an, bn = f.main(0, 1), f.main(1, 1)
        f.assert_zero_first_row(a - f.public(0))
        f.assert_zero_first_row(b - f.public(1))
        f.assert_transition(an - b)
        f.assert_transition(bn - (a + b))
        f.assert_zero_last_row(b - f.public(2))


class ProductAir(Air):
    """tests/test_stark_e2e.py's ProductAir: a running product
    ``A_{i+1} = A_i·(γ − v_{i+1})`` with the final product as aux value."""

    width = 1
    aux_width = 1
    num_randomness = 1
    num_aux_values = 1
    num_public_values = 3

    def eval(self, f):
        v = f.main(0)
        vn = f.main(0, 1)
        a = f.aux(0)
        an = f.aux(0, 1)
        g = f.rand(0)
        f.assert_zero_first_row(a - (g - v))
        f.assert_transition(an - a * (g - vn))
        f.assert_zero_last_row(a - f.aux_value(0))

    def build_aux_trace(self, main, publics, aux_inputs, randomness):
        g = tuple(int(v) for v in F.to_numpy(randomness[0]))
        acc, rows = (1, 0), []
        for v in F.to_numpy(main[:, 0]):
            acc = gl.ext_mul(acc, gl.ext_sub(g, (int(v), 0)))
            rows.append(acc)
        aux = F.to_torch(np.asarray(rows, dtype=np.uint64), main.device)
        return aux, aux[-1:].clone()


def fib_trace(n: int) -> np.ndarray:
    rows, a, b = [], 0, 1
    for _ in range(n):
        rows.append((a, b))
        a, b = b, gl.add(a, b)
    return np.array(rows, dtype=np.uint64)


def fib_product_statement() -> tuple:
    """tests/test_dist.py's sharded statement: Fib 2^10 and a random
    ProductAir column of 2^7 rows."""
    fib = fib_trace(1 << 10)
    prod = rand_u64((1 << 7, 1), 9)
    return Statement(MultiAir([FibAir(), ProductAir()]), [0, 1, int(fib[-1, 1])]), [fib, prod]


def fib_product_proof(rank: int) -> tuple:
    statement, traces = fib_product_statement()
    res = prove_sharded(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), make_mesh("cpu"))
    return proof_to_bytes(res.proof), res.digest


VM_FIB = "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end"


def vm_fib_proof(rank: int) -> bytes:
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import prove_program

    with use_mesh(make_mesh("cpu")):
        _, proof = prove_program(assemble(VM_FIB), params=TEST_PARAMS, device="cpu")
    return proof.to_bytes()
