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
from miden_tpu_torch.dist.prover import prove_sharded
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.merkle import lmcs
from miden_tpu_torch.stark import TEST_PARAMS
from miden_tpu_torch.stark.air import Air, MultiAir
from miden_tpu_torch.stark.proof_io import proof_to_bytes
from miden_tpu_torch.stark.prover import Statement, commit_traces
from miden_tpu_torch.transcript import challenger as C

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


def rand_u64(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, gl.P, size=shape, dtype=np.uint64)


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


def sharded_checks(rank: int) -> dict:
    """On 8 ranks: the LDE cases and the mixed-height tree on all 8, the LDE
    cases again on groups of 2 and 4, the commit hook on 2 ranks under
    poseidon2 and rpo256, ``prove_sharded`` of ``miden_shaped_statement(6)``
    at ``TEST_PARAMS`` on 4, then a broadcast and chip_smoke phase 12b's
    commit check (``bench_dist.lde_tree_check``) at a small size on all 8."""
    from miden_tpu_torch.bench_airs import miden_shaped_statement

    mesh8 = make_mesh("cpu")
    groups = {d: dist.new_group(list(range(d))) for d in (2, 4)}  # every rank joins the call
    out = {"lde": {8: _lde_blocks(mesh8)}}
    tree = build_tree_sharded([F.to_torch(m, "cpu") for m in tree_inputs()], mesh8)
    out["tree_layers"] = [F.to_numpy(layer) for layer in tree.layers]
    out["tree_hints"] = opening_hints(tree, OPEN_INDICES)
    for d, group in groups.items():
        if rank < d:
            out["lde"][d] = _lde_blocks(make_mesh("cpu", group=group))
    if rank < 2:
        mesh2 = make_mesh("cpu", group=groups[2])
        with use_mesh(mesh2):
            traces = [F.to_torch(m, "cpu") for m in commit_inputs()]
            out["commit_roots"] = {
                name: commit_traces(traces, 2, hash=cfg).root()
                for name, cfg in (("poseidon2", lmcs.POSEIDON2_HASH), ("rpo256", lmcs.RPO_HASH))
            }
    if rank < 4:
        statement, traces = miden_shaped_statement(6, device="cpu")
        res = prove_sharded(TEST_PARAMS, statement, traces, C.DuplexChallenger(SEED), make_mesh("cpu", groups[4]))
        out["proof"] = (proof_to_bytes(res.proof), res.digest)
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
