"""Multi-device proving on the card: the port's ``dist/`` (``chip_smoke.py`` phase 12).

    python3 -m miden_tpu_torch.bench_dist [--parent DIR]

vm-fib-18 (``bench_quotient.FIB_18`` at ``MIDEN_PARAMS``) three ways:

- one device, eagerly, with the peak allocated memory of each phase
  (:func:`phase_peaks`): which stage sets the proof's peak;
- (12a) ``prove_program`` under ``use_mesh(make_mesh("cuda"))``, an NCCL
  group of this one process: the fused phases, captured with their NCCL
  collectives: the eager warm-up, the capture call and a replay, each
  against the one-device bytes (:func:`nccl_prove`);
- (12d) ``prove_sharded`` on ``RANKS`` gloo ranks sharing the card
  (:func:`sharded_ranks`): each rank's bytes, seconds, peak (and per
  phase), the bytes it holds of the max-height tensors at the end of
  ``stage_open`` beside one device's (:func:`~.dist.prover.held_bytes`),
  the traffic of each collective, the launches of K1, K2, K3 and Q1, and Q1
  held to its plain twin at each block-and-halo shape it ran.

With ``--parent DIR`` (a ``git archive`` of an earlier commit), the
parent's ``prove_sharded`` of vm-fib-18 on the same ranks, in turns with
this tree's (parent, this, this, parent), each a process of its own
(``bench_dist_ab.py``): seconds, peak and bytes per rank. Prints one JSON
line.

NCCL refuses two ranks on one device, so with one card NCCL runs at world
size 1 only; gloo moves the blocks through host memory. The parent builds
the kernels and the C trace generator before it starts the ranks, which
only load them (:func:`~.utils.cuda.load_built`).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .bench_kernels import KERNELS
from .bench_quotient import FIB_18
from .dist import make_mesh, use_mesh
from .dist.mesh import RowShard, run_ranks
from .dist.prover import held_bytes, prove_sharded_env
from .stark import MIDEN_PARAMS
from .utils import cuda

RANKS = 4  # gloo ranks sharing the card in (12d)
#: the kernels a sharded VM proof launches on each rank (K1, K2, K3, Q1 and D1)
RANK_KERNELS = ["ntt_col_transform", "ntt_transpose_twiddle", "poseidon2_absorb_rows",
                "poseidon2_compress_rows", "poseidon2_permute", "constraints_eval", "deep_ood_sums",
                "deep_reduce_rows"]
#: points of a block at which Q1 is held to its plain twin (the block's
#: first and last points, whose next rows come from the halo, and a stride)
Q1_SAMPLE = 1 << 12


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


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class PeakHook:
    """``run_phases``' ``after`` hook: the peak allocated bytes of each
    phase (the counter is reset at each phase's start)."""

    def __init__(self):
        self.peaks: dict = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def __call__(self, name: str) -> None:
        torch.cuda.synchronize()
        self.peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()


def phase_peaks(program, mesh=None) -> dict:
    """vm-fib-18 proved eagerly (over ``mesh``, or on this card alone), with
    the peak of each phase: ``{seconds, peak, phases, held, bytes,
    traffic}`` (``held``: :func:`~.dist.prover.held_bytes` over the mesh's
    ranks, or over RANKS for one device)."""
    from .transcript.challenger import DuplexChallenger
    from .vm.prove import protocol_seed, trace_program, vm_proof

    out, trace, statement, traces = trace_program(program)
    hook = PeakHook()
    t0 = time.perf_counter()
    res, env = prove_sharded_env(MIDEN_PARAMS, statement, traces, DuplexChallenger(protocol_seed()), mesh,
                                 after=hook)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    held = held_bytes(env, MIDEN_PARAMS, mesh.size if mesh is not None else RANKS)
    del env
    return {"seconds": secs, "peak": max(hook.peaks.values()), "phases": hook.peaks, "held": held,
            "bytes": vm_proof(out, trace, res.proof).to_bytes(),
            "traffic": dict(mesh.traffic) if mesh is not None else None}


def q1_key(air, domain, main_lde, log_d: int, mesh) -> tuple:
    """Q1's shape key (``interp.q1_shape_key``) of an ``evaluate_quotient``
    call: this rank's block and ``"halo"`` where ``main_lde`` is a RowShard."""
    nd = domain.trace_height << log_d
    if isinstance(main_lde, RowShard):
        return (type(air).__name__, nd // mesh.size, "halo")
    return (type(air).__name__, nd)


class Q1Keeper:
    """Keeps the arguments of the first ``evaluate_quotient`` call through
    the program at each of Q1's shapes (the block and halo of a rank) while
    installed, and holds Q1 to its plain twin there afterwards."""

    def __init__(self):
        from .stark import prover

        self.kept: dict = {}
        self.real = prover.evaluate_quotient

        def watched(*args):
            air, domain, main_lde, _, log_d = args[:5]
            if prover.uses_program(air, domain.trace_height, log_d) and not cuda.capturing():
                self.kept.setdefault(q1_key(air, domain, main_lde, log_d, args[10]), args)
            return self.real(*args)

        prover.evaluate_quotient = watched

    def close(self) -> None:
        from .stark import prover

        prover.evaluate_quotient = self.real

    def check(self) -> dict:
        """{shape key: {err, points, nd, ms}}: Q1 against its twin over the
        block's first and last Q1_SAMPLE/4 points and Q1_SAMPLE/2 spread
        points; Q1's ms a launch (CUDA events)."""
        from .bench_kernels import time_ms
        from .stark import interp, prover

        out = {}
        for key, args in self.kept.items():
            prog, inp, _ = prover.quotient_program_inputs(*args)
            nd = inp.nd
            q = Q1_SAMPLE // 4
            stride = max(1, nd // (2 * q))
            idx = torch.cat([torch.arange(q), torch.arange(nd - q, nd), torch.arange(2 * q) * stride])
            idx = torch.unique(idx.clamp(0, nd - 1)).to(inp.scal.device)
            got = interp.run_program_kernel(prog, inp)[idx]
            want = interp.run_program_plain(prog, inp, idx)
            err = int((got - want).abs().max()) if not torch.equal(got, want) else 0
            ms = time_ms(lambda: interp.run_program_kernel(prog, inp), 3)
            out[key] = {"err": err, "points": int(idx.numel()), "nd": nd, "ms": ms}
        self.kept.clear()
        return out


#: vm-fib-18's main trace: (log height, width) of the core, chiplets and
#: Poseidon2 AIRs (proof order puts the core last; here it comes first)
VM_MAIN_SHAPES = [(18, 51), (13, 24), (16, 16)]
SEED = 18


def card_rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform canonical field elements drawn on ``device`` (values ≥ p, as
    int64 v in (−2^32, 0), wrap to v − p)."""
    halves = torch.randint(0, 1 << 32, (2, *shape), generator=gen, dtype=torch.int64, device=device)
    v = (halves[0] << 32) | halves[1]
    return torch.where((v < 0) & (v > -(1 << 32)), v + ((1 << 32) - 1), v)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def lde_tree_check(rank: int, mesh, kernels: dict, shapes=VM_MAIN_SHAPES) -> dict:
    """The sharded commit of random traces of ``shapes`` (the first
    row-sharded as the prover shards its max-height trace, the others
    whole), timed after a warm-up, against the single-device result (timed
    after a warm-up too, while the other ranks may still use the card):
    this rank's LDE rows, every layer (the sharded ones gathered) and every
    matrix."""
    from .dist.lmcs_dist import build_tree_sharded
    from .dist.mesh import gather_rows
    from .dist.ntt_dist import coset_lde_sharded
    from .field import gl
    from .merkle import lmcs
    from .ntt import ntt

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
    traffic = dict(mesh.traffic)
    dist.barrier(group=mesh.group)
    _sync(mesh.device)
    t0 = time.perf_counter()
    core, tree = sharded()
    _sync(mesh.device)
    secs = time.perf_counter() - t0
    traffic = {k: v - traffic[k] for k, v in mesh.traffic.items()}
    launches, launch_shapes = read_counts(kernels)
    layers = [gather_rows(x, mesh) for x in tree.layers]
    matrices = [gather_rows(m, mesh) for m in tree.matrices]

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
        "seconds": secs, "single_seconds": single_secs, "traffic": traffic,
        "launches": launches, "shapes": launch_shapes,
        "rows_equal": torch.equal(core.local, ldes[0][rank * rows : (rank + 1) * rows]),
        "layers_equal": len(layers) == len(ref.layers) and all(torch.equal(a, b) for a, b in zip(layers, ref.layers)),
        "matrices_equal": all(torch.equal(a, b) for a, b in zip(matrices, ldes)),
        "root": [int(v) for v in tree.root()],
        "lde_rows": [rank * rows, (rank + 1) * rows],
        "layers": len(tree.layers),
    }


def sharded_rank(rank: int, src: str, small: str | None) -> dict:
    """(12d) on one gloo rank of the shared card: ``src`` proved by
    ``prove_sharded``, eagerly, with its peak and the rest of
    :func:`phase_peaks`, its kernels' launches, and Q1 held to its twin;
    then, on ranks 0 and 1, ``small`` through ``prove_program`` under a
    mesh of the two (12c): its bytes and launches."""
    from .vm import assemble
    from .vm.prove import prove_program

    cuda.load_built()
    kernels = kernel_objects()
    mesh = make_mesh("cuda")
    keeper = Q1Keeper()
    try:
        zero_counts(kernels)
        res = phase_peaks(assemble(src), mesh)
        res["launches"], res["shapes"] = read_counts(kernels)
        if small is not None:
            pair = dist.new_group([0, 1])  # every rank joins the call
            if rank < 2:
                zero_counts(kernels)
                with use_mesh(make_mesh("cuda", group=pair)):
                    _, proof = prove_program(assemble(small), params=MIDEN_PARAMS, device=mesh.device)
                torch.cuda.synchronize()
                launches, shapes = read_counts(kernels)
                res["small"] = {"bytes": proof.to_bytes(), "launches": launches, "shapes": shapes}
    finally:
        keeper.close()
    res["q1"] = keeper.check()  # the same shapes in the same order on every rank of a mesh
    res["commit"] = lde_tree_check(rank, mesh, kernels)  # after the proof: its reference adds to the peak
    return res


def sharded_ranks(src: str = FIB_18, small: str | None = None) -> list:
    """(12d) on ``RANKS`` spawned gloo ranks that share the card, after
    building every kernel and the trace generator here."""
    from . import native

    cuda.build_all()
    native.trace_gen_lib()
    torch.cuda.empty_cache()  # the ranks share this card's memory
    return run_ranks(RANKS, sharded_rank, (src, small), backend="gloo", threads=2)


def nccl_prove(program, kernels: dict) -> dict:
    """(12a): ``prove_program`` under ``use_mesh(make_mesh("cuda"))``, an
    NCCL group of this one process: three calls, the eager warm-up, the
    capture call and a replay, each timed, with the replay's launches and
    the graphs' statistics; the group is left (and the plan released) at
    the end."""
    from .stark import fused
    from .vm.prove import prove_program

    mesh = make_mesh("cuda")
    try:
        calls = []
        for _ in range(3):
            zero_counts(kernels)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_mesh(mesh):
                _, proof = prove_program(program, params=MIDEN_PARAMS, device=mesh.device)
            torch.cuda.synchronize()
            launches, shapes = read_counts(kernels)
            calls.append({"seconds": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated(),
                          "bytes": proof.to_bytes(), "launches": launches, "shapes": shapes})
        plan = fused.cached_plan()
        if plan is None or not plan.captured or plan.key[-1] != (1, 0, "nccl"):
            raise AssertionError("12a: the proofs under the NCCL mesh were not captured into the fused phases")
        return {"calls": calls, "backend": mesh.backend, "world": mesh.size, "traffic": dict(mesh.traffic),
                "graphs": plan.phase_stats()}
    finally:
        fused.release()
        dist.destroy_process_group()


def ab_runs(parent: Path, this: Path, src: str) -> list:
    """The parent's ``prove_sharded`` and this tree's on RANKS gloo ranks,
    in turns (parent, this, this, parent), each a process of its own
    (``bench_dist_ab.py``): ``[(label, per-rank results)]``."""
    script = Path(__file__).with_name("bench_dist_ab.py")
    out = []
    for label, root in (("parent", parent), ("this", this), ("this", this), ("parent", parent)):
        env = {**os.environ, "BENCH_DIST_ROOT": str(root)}
        res = subprocess.run([sys.executable, str(script), src, str(RANKS)], capture_output=True, text=True,
                             cwd=root, env=env, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"the {label} run failed:\n{res.stderr[-4000:]}")
        out.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
        log(f"  {label}: " + "; ".join(f"rank {k} {r['seconds']:.4f} s, peak {r['peak'] / 2**30:.3f} GiB"
                                        for k, r in enumerate(out[-1][1])))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="root of an earlier checkout: its prove_sharded in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_dist: no CUDA device")
    from .vm import assemble
    from .vm.prove import prove_program

    card = card_name()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cuda.build_all()
    kernels = kernel_objects()
    program = assemble(FIB_18)
    prove_program(program, params=MIDEN_PARAMS, fused=False)  # loads every kernel, makes the tables
    one = phase_peaks(program)
    log(f"one device, eager: {one['seconds']:.4f} s, peak {one['peak'] / 2**30:.3f} GiB; per phase (GiB): "
        + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in one["phases"].items())
        + f"; max-height tensors held at the end of stage_open {one['held']['whole'] / 2**30:.3f} GiB")
    a = nccl_prove(program, kernels)
    for name, call in zip(("warm-up", "capture", "replay"), a["calls"]):
        log(f"12a {name}: {call['seconds']:.4f} s, peak {call['peak'] / 2**30:.3f} GiB, bytes "
            f"{'==' if call['bytes'] == one['bytes'] else '!='} one device's")
    ranks = sharded_ranks()
    for k, r in enumerate(ranks):
        log(f"12d rank {k}: {r['seconds']:.4f} s, peak {r['peak'] / 2**30:.3f} GiB (one device "
            f"{one['peak'] / 2**30:.3f}), held {r['held']['local'] / 2**30:.4f} of "
            f"{r['held']['whole'] / 2**30:.4f} GiB, bytes {'==' if r['bytes'] == one['bytes'] else '!='}, "
            f"traffic {r['traffic']}, Q1 {r['q1']}")
    result = {
        "card": card,
        "one_device": {k: one[k] for k in ("seconds", "peak", "phases", "held")},
        "a": [{k: c[k] for k in ("seconds", "peak", "launches")} | {"bytes_equal": c["bytes"] == one["bytes"]}
              for c in a["calls"]],
        "a_graphs": a["graphs"],
        "d": [{k: r[k] for k in ("seconds", "peak", "phases", "held", "traffic", "launches")}
              | {"bytes_equal": r["bytes"] == one["bytes"], "q1": {str(k): v for k, v in r["q1"].items()},
                 "commit": {k: r["commit"][k] for k in ("seconds", "single_seconds", "traffic", "rows_equal",
                                                         "layers_equal", "matrices_equal")}}
              for r in ranks],
    }
    if args.parent:
        result["ab"] = ab_runs(args.parent.resolve(), Path(__file__).resolve().parents[1], FIB_18)
    log(json.dumps(result))
    ok = all(c["bytes_equal"] for c in result["a"]) and all(
        r["bytes_equal"] and not r["held"]["not_sharded"] and all(q["err"] == 0 for q in r["q1"].values())
        and r["commit"]["rows_equal"] and r["commit"]["layers_equal"] and r["commit"]["matrices_equal"]
        for r in result["d"])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
