"""Multi-device proving on the card: the port's ``dist/`` (``chip_smoke.py`` phase 12).

    python3 -m miden_tpu_torch.bench_dist

(a) vm-fib-18 (``bench_quotient.FIB_18``) through ``prove_program`` under
``use_mesh(make_mesh("cuda"))``, an NCCL group of one rank, against the same
call without a mesh: seconds, peak memory, equal bytes. (b) On ``RANKS``
gloo ranks that share the card: ``coset_lde_sharded`` and
``build_tree_sharded`` at the shapes of vm-fib-18's main trace (random
values from a seed), each rank's LDE rows, every layer and the root against
the single-device result on the card, with the seconds and the bytes each
rank moved, and which gloo collectives take CUDA tensors. (c) On two of
those ranks, ``prove_program`` of fib ``repeat.10`` at ``MIDEN_PARAMS``
under the mesh against the single-device proof. Prints one JSON line.

NCCL refuses two ranks on one device, so with one card NCCL runs at world
size 1 only; gloo moves the blocks through host memory. The parent builds
the kernels and the C trace generator before it starts the ranks, which
only load them (:func:`~.utils.cuda.load_built`).
"""

from __future__ import annotations

import importlib
import json
import subprocess
import time

import torch
import torch.distributed as dist

from .bench_kernels import KERNELS
from .bench_quotient import FIB_18
from .dist import make_mesh, use_mesh
from .dist.lmcs_dist import build_tree_sharded
from .dist.mesh import run_ranks
from .dist.ntt_dist import coset_lde_sharded
from .field import gl
from .merkle import lmcs
from .ntt import ntt
from .stark import MIDEN_PARAMS
from .utils import cuda

#: vm-fib-18's main trace: (log height, width) of the core, chiplets and
#: Poseidon2 AIRs (proof order puts the core last; here it comes first)
VM_MAIN_SHAPES = [(18, 51), (13, 24), (16, 16)]
FIB_SMALL = "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end"
RANKS = 4  # gloo ranks sharing the card in (b)
SEED = 18
#: the kernel entries a sharded LDE and tree launch (no permute: no transcript)
COMMIT_KERNELS = ["ntt_col_transform", "ntt_transpose_twiddle", "poseidon2_absorb_rows", "poseidon2_compress_rows"]


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_objects() -> dict:
    """Kernel entry name -> its ``cuda.Kernel`` (launch counts and shapes)."""
    out = {}
    for name, (mod, attr) in KERNELS.items():
        obj = importlib.import_module(f"{__package__}.{mod}")
        for part in attr.split("."):
            obj = getattr(obj, part)
        out[name] = obj
    return out


def zero_counts(kernels: dict) -> None:
    for kern in kernels.values():
        kern.launches = 0
        kern.shapes.clear()


def read_counts(kernels: dict) -> tuple:
    """({entry: launches}, {entry: {shape key: launches}})."""
    return ({k: kern.launches for k, kern in kernels.items()},
            {k: dict(kern.shapes) for k, kern in kernels.items()})


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform canonical field elements drawn on the card (values ≥ p, as
    int64 v in (−2^32, 0), wrap to v − p)."""
    halves = torch.randint(0, 1 << 32, (2, *shape), generator=gen, dtype=torch.int64, device=device)
    v = (halves[0] << 32) | halves[1]
    return torch.where((v < 0) & (v > -(1 << 32)), v + ((1 << 32) - 1), v)


def probe_gloo_cuda(mesh) -> dict:
    """Which gloo collectives take CUDA tensors: each collective once on a
    card tensor, its error's first line where it refuses (a measurement of
    the backend, not a path of the port: ``dist.mesh`` stages every gloo
    transfer through host memory). Point-to-point is not probed: the
    exchanges send CPU tensors over gloo."""
    x = torch.arange(4, dtype=torch.int64, device=mesh.device)
    calls = {
        "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=mesh.group),
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=mesh.group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(mesh.size)], x, group=mesh.group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * mesh.size, dtype=torch.int64, device=mesh.device), x, group=mesh.group),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as exc:  # recorded, never retried another way
            out[name] = f"refuses: {str(exc).splitlines()[0][:120]}"
    return out


def lde_tree_check(rank: int, mesh, kernels: dict, shapes=VM_MAIN_SHAPES) -> dict:
    """The sharded commit of random traces of ``shapes`` (the first
    row-sharded as the prover shards its max-height trace, the others
    whole), timed after a warm-up, against the single-device result (timed
    after a warm-up too, while the other ranks may still use the card)."""
    blowup = MIDEN_PARAMS.log_blowup
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(SEED)
    traces = [card_rand(gen, (1 << log_n, w), mesh.device) for log_n, w in shapes]
    shifts = [gl.canonical_lde_shift(log_n + blowup) for log_n, _ in shapes]

    def sharded():
        core = coset_lde_sharded(traces[0], blowup, shifts[0], mesh)
        others = [ntt.coset_lde(t, blowup, s) for t, s in zip(traces[1:], shifts[1:])]
        return core, build_tree_sharded([core, *others], mesh)

    sharded()
    zero_counts(kernels)
    mesh.traffic.update(exchange=0, gather=0)
    dist.barrier(group=mesh.group)
    _sync(mesh.device)
    t0 = time.perf_counter()
    core, tree = sharded()
    _sync(mesh.device)
    secs = time.perf_counter() - t0
    launches, launch_shapes = read_counts(kernels)

    def single():
        ldes = [ntt.coset_lde(t, blowup, s) for t, s in zip(traces, shifts)]
        return ldes, lmcs.build_tree(ldes)

    single()
    _sync(mesh.device)
    t0 = time.perf_counter()
    ldes, ref = single()
    _sync(mesh.device)
    single_secs = time.perf_counter() - t0
    rows = core.local.shape[0]
    return {
        "seconds": secs, "single_seconds": single_secs, "traffic": dict(mesh.traffic),
        "launches": launches, "shapes": launch_shapes,
        "rows_equal": torch.equal(core.local, ldes[0][rank * rows : (rank + 1) * rows]),
        "layers_equal": len(tree.layers) == len(ref.layers)
        and all(torch.equal(a, b) for a, b in zip(tree.layers, ref.layers)),
        "matrices_equal": all(torch.equal(a, b) for a, b in zip(tree.matrices, ldes)),
        "root": [int(v) for v in tree.root()],
        "lde_rows": [rank * rows, (rank + 1) * rows],
        "layers": len(tree.layers),
    }


def program_check(mesh, kernels: dict) -> dict:
    """``prove_program`` of ``FIB_SMALL`` at ``MIDEN_PARAMS`` under ``mesh``."""
    from .vm import assemble
    from .vm.prove import prove_program

    zero_counts(kernels)
    t0 = time.perf_counter()
    with use_mesh(mesh):
        _, proof = prove_program(assemble(FIB_SMALL), params=MIDEN_PARAMS, device=mesh.device)
    _sync(mesh.device)
    launches, launch_shapes = read_counts(kernels)
    return {"seconds": time.perf_counter() - t0, "bytes": proof.to_bytes(),
            "launches": launches, "shapes": launch_shapes}


def gloo_rank(rank: int) -> dict:
    """One gloo rank on the shared card: the probe and (b) on every rank,
    then (c) on ranks 0 and 1."""
    cuda.load_built()
    kernels = kernel_objects()
    mesh = make_mesh("cuda")
    out = {"probe": probe_gloo_cuda(mesh), "lde_tree": lde_tree_check(rank, mesh, kernels)}
    pair = dist.new_group([0, 1])  # every rank joins the call
    if rank < 2:
        out["program"] = program_check(make_mesh("cuda", group=pair), kernels)
    return out


def gloo_ranks() -> list:
    """(b) and (c) on ``RANKS`` spawned gloo ranks that share the card,
    after building every kernel and the trace generator here."""
    from . import native

    cuda.build_all()
    native.trace_gen_lib()
    torch.cuda.empty_cache()  # the ranks share this card's memory
    return run_ranks(RANKS, gloo_rank, backend="gloo", threads=2)


def nccl_prove(program, kernels: dict) -> dict:
    """(a): ``prove_program`` under ``use_mesh(make_mesh("cuda"))``, an NCCL
    group of this one process, which it leaves at the end."""
    from .vm.prove import prove_program

    mesh = make_mesh("cuda")
    try:
        zero_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_mesh(mesh):
            _, proof = prove_program(program, params=MIDEN_PARAMS, device=mesh.device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, launch_shapes = read_counts(kernels)
        return {"seconds": secs, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "backend": mesh.backend, "world": mesh.size, "traffic": dict(mesh.traffic),
                "bytes": proof.to_bytes(), "launches": launches, "shapes": launch_shapes}
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_dist: no CUDA device")
    from .vm import assemble
    from .vm.prove import prove_program

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cuda.build_all()
    kernels = kernel_objects()
    program = assemble(FIB_18)
    # eager (fused=False), as under the mesh, which the fused path does not take
    prove_program(program, params=MIDEN_PARAMS, fused=False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = prove_program(program, params=MIDEN_PARAMS, fused=False)[1].to_bytes()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    a = nccl_prove(program, kernels)
    small = prove_program(assemble(FIB_SMALL), params=MIDEN_PARAMS)[1].to_bytes()
    ranks = gloo_ranks()
    result = {
        "card": card,
        "a": {"seconds": a["seconds"], "peak_gib": a["peak_gib"], "single_seconds": single_s,
              "single_peak_gib": single_peak, "bytes_equal": a["bytes"] == single},
        "b": [{k: r["lde_tree"][k] for k in
               ("seconds", "single_seconds", "traffic", "rows_equal", "layers_equal", "matrices_equal")}
              for r in ranks],
        "c": [r["program"]["bytes"] == small for r in ranks[:2]],
        "gloo_cuda": ranks[0]["probe"],
    }
    log(json.dumps(result))
    ok = result["a"]["bytes_equal"] and all(result["c"]) and all(
        r["rows_equal"] and r["layers_equal"] and r["matrices_equal"] for r in result["b"])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
