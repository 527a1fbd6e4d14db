#!/usr/bin/env python3
"""Smoke run of the PyTorch port (miden_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (plus details):

1. build the CUDA kernels from miden_tpu_torch/csrc (one nvcc per source,
   in parallel) and the C trace generator (miden_tpu_torch/native);
2. hold each kernel entry (K1 ntt_col_transform, K2 ntt_transpose_twiddle,
   K3 poseidon2_permute, poseidon2_absorb_rows, poseidon2_compress_rows)
   against its plain torch twin on the card, exact equality, on inputs from
   a seeded numpy generator;
3. prove miden_shaped_statement(10) at MIDEN_PARAMS on the card and on the
   CPU: the proof bytes must be equal and the port's verifier must accept;
4. prove miden_shaped_statement(18) at MIDEN_PARAMS on the card (core
   2^18 x 51 with 8 EF aux columns, chiplets 2^16 x 22, perm 2^14 x 16, LDE
   2^21 rows): one warm-up, one timed prove (CUDA events), its kernel
   launch counts (per entry, and K3's permutations per shape), the span
   breakdown of one traced prove, peak memory, and the verifier's verdict;
5. the VM facade, the port's main path: (a) prove_program of the fib
   program (repeat.10) at MIDEN_PARAMS on the card and on the CPU, proof
   bytes equal and verify_program accepting; (b) the fib program with
   repeat.84000 (core 2^18 rows, bench.py's real-program row) at
   MIDEN_PARAMS: one warm-up and three timed prove_program calls (host
   clock around the whole call, as bench.py times it), execute_and_trace's
   time beside them, the AIRs' log heights, the kernel launch counts of one
   proof (every entry must be launched), the span breakdown of one traced
   prove, peak memory, the proof size, verify_program's verdict and the
   top of the stack against fib mod p;
   (c) the trace of (b) was written by the C trace generator, not the
   Python interpreter;
6. the precompile session, the second STARK: (a) the pinned sessions of
   ``miden_tpu_torch.bench_session`` (U256_SESSION, MIXED_SESSION with every
   session AIR, and its two halves) proved at TEST_PARAMS on the card, their
   proof bytes' SHA-256 equal to the pinned ones, verified, and the bytes
   written to smoke_out/; only U256_SESSION's digest is of CPU bytes, so
   the keccak and EC AIRs' aux traces and quotients on MIXED_SESSION's
   traces are also held bit-equal to the CPU's; (b)
   ``bench_session.stdlib_session_program()`` (8 in-VM ECDSA verifications,
   8 x keccak256::hash_memory of 1 KiB, a 32-deep keccak256::merge path)
   through prove_program at MIDEN_PARAMS, then its
   deferred state through prove_deferred_state_dag on the card: one traced
   warm-up and two timed session proofs, the trace-build time, the AIRs' log
   heights, launches, spans, peak memory, proof size, and
   verify_program(proof, deferred=session) accepting where a tampered root
   and a missing session are rejected;
7. hold each kernel against its plain twin and time it, with its bound, at
   every shape phases 4, 5(b) and 6(b) launched it with (K1 printed at each
   shape), with its time per shaped, VM and session proof;
8. the device-busy share of one more VM fib-18 prove_program under
   torch.profiler (last on the card: after the profiler every launch costs
   the host more), the JSON line of kernels, the card's name and power
   limit, and the result line ``{"ok": true, "device": {...}}`` last.

Any failure raises and the script exits non-zero without a result line. It
needs one CUDA device, and the repository around it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = [0x6D69, 0x6465, 0x6E2D, 0x7470]  # the bench's domain separator
SMALL_LOG, FULL_LOG = 10, 18
VM_SMALL_REPS, VM_FULL_REPS = 10, 84000  # fib loop: 3 VM ops a repeat


def fib_program(reps: int) -> str:
    """bench.py's real-program row (bench.py:59-64)."""
    return f"begin push.0 push.1 repeat.{reps} swap dup.1 add end swap drop swap drop end"


def fib_top(reps: int, p: int) -> int:
    """What fib_program(reps) leaves on top of the stack: F(reps + 1) mod p."""
    a, b = 0, 1
    for _ in range(reps):
        a, b = b, (a + b) % p
    return b


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def log_phase(msg: str) -> None:
    """A phase's summary line, with the seconds since the script started."""
    log(f"{msg} [{time.perf_counter() - T0:.1f} s in]")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def int32_mul_rate(torch) -> float:
    """32-bit integer multiplies per second: 64 INT32 lanes per SM per clock
    (Hopper SM) x SMs x the card's maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return 64 * sms * mhz * 1e6


def max_abs_err(a, b) -> int:
    """Largest |a − b| over the u64 values (0 when equal)."""
    from miden_tpu_torch.field.goldilocks import to_numpy

    x, y = to_numpy(a), to_numpy(b)
    bad = x != y
    if not bad.any():
        return 0
    return max(abs(int(u) - int(v)) for u, v in zip(x[bad], y[bad]))


def device_busy(torch, fn) -> str:
    """One run of ``fn`` under torch.profiler: device time (kernels, copies,
    fills) against wall time, and the kernels that take the most device
    time. Only device activity is traced. The events are read from the
    profiler's Chrome trace, which kineto writes in C++: building Python
    event objects for the ~600k launches of a VM proof (``key_averages``)
    took minutes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke_out", "device_busy.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    os.remove(path)
    sums: dict = {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev:
            entry = sums.setdefault(ev["name"].removeprefix("void ").removeprefix("at::native::"), [0.0, 0])
            entry[0] += ev["dur"]
            entry[1] += 1
    if not sums:
        return f"wall {wall:.4f} s under the profiler; device time not measured (no device events)"
    rows = sorted(((us, k, c) for k, (us, c) in sums.items()), reverse=True)
    total = sum(r[0] for r in rows) / 1e6
    top = "; ".join(f"{k[:100]} {us / 1e3:.2f} ms x{c}" for us, k, c in rows[:8])
    return (f"wall {wall:.4f} s under the profiler, device busy {total:.4f} s "
            f"({100 * total / wall:.1f} %); top: {top}")


def kernel_table() -> dict:
    """Kernel entry -> (its cuda.Kernel, source, the TPU kernel it replaces)."""
    from miden_tpu_torch.hash import poseidon2
    from miden_tpu_torch.ntt import ntt

    return {
        "ntt_col_transform": (ntt.COL_KERNEL, "miden_tpu_torch/csrc/ntt.cu",
                              "miden_tpu/ntt/ntt_pallas.py:158"),
        "ntt_transpose_twiddle": (ntt.TRANSPOSE_KERNEL, "miden_tpu_torch/csrc/ntt.cu",
                                  "miden_tpu/ntt/ntt_pallas.py:267"),
        "poseidon2_permute": (poseidon2.PERMUTE_KERNEL, "miden_tpu_torch/csrc/poseidon2.cu",
                              "miden_tpu/hash/poseidon2_pallas.py:156"),
        "poseidon2_absorb_rows": (poseidon2.ABSORB_KERNEL, "miden_tpu_torch/csrc/poseidon2.cu",
                                  "miden_tpu/hash/poseidon2_pallas.py:156"),
        "poseidon2_compress_rows": (poseidon2.COMPRESS_KERNEL, "miden_tpu_torch/csrc/poseidon2.cu",
                                    "miden_tpu/hash/poseidon2_pallas.py:156"),
    }


def zero_counts(kernels) -> None:
    for kern, _, _ in kernels.values():
        kern.launches = 0
        kern.shapes.clear()


def record_shapes(kernels, into) -> None:
    for name, (kern, _, _) in kernels.items():
        for key, count in kern.shapes.items():
            into[name][key] = into[name].get(key, 0) + count


def session_airs_card_vs_cpu(torch, dev: str) -> str:
    """The three MIXED digests were minted on the card, so they show only
    that the card repeats itself. This holds the card to the CPU without a
    CPU proof (whose LMCS lift to the range table's 2^20-row LDE takes
    hours): on MIXED_SESSION's traces and publics, each of the keccak and EC
    AIRs builds its LogUp aux trace, and evaluates its quotient over the
    LDEs at TEST_PARAMS' blowup, on the card and on the CPU, from the same
    seeded randomness and α. Every output must be bit-equal."""
    from miden_tpu_torch import bench_session as BS
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.field import goldilocks as F
    from miden_tpu_torch.ntt import ntt
    from miden_tpu_torch.precompile import session as S
    from miden_tpu_torch.stark import TEST_PARAMS
    from miden_tpu_torch.stark.domains import LiftedDomain, log_quotient_degree
    from miden_tpu_torch.stark.prover import evaluate_quotient

    claims = BS.claims(BS.MIXED_SESSION)
    tr = S.build_session_traces(claims)
    kinds = {"U256AddClaim", "U256MulClaim"}, {"Keccak256Claim"}, {"EcAddClaim", "EcMulClaim"}
    counts = [sum(type(c).__name__ in k for c in claims) for k in kinds]
    statement = S._session_statement(tr.root, len(claims), *counts)
    rng = np.random.default_rng(7)
    checked = []
    for air, trace in zip(statement.multi_air.airs[4:], (tr.keccak, tr.kvar, tr.sponge, tr.ec_op, tr.ec_mac)):
        rand = rng.integers(0, gl.P, size=(air.num_randomness + 1, 2), dtype=np.uint64)
        log_n = trace.shape[0].bit_length() - 1
        dom = LiftedDomain.canonical(log_n, TEST_PARAMS.log_blowup)
        log_d = log_quotient_degree(air.constraint_degree())

        def run(device):
            r = F.to_torch(rand, device)
            main = F.to_torch(np.asarray(trace, dtype=np.uint64), device)
            aux, vals = air.build_aux_trace(main, statement.publics, [], list(r[:-1]))
            lde = [ntt.coset_lde(m, TEST_PARAMS.log_blowup, dom.lde_shift) for m in (main, aux)]
            pubs = F.to_torch(np.asarray([p % gl.P for p in statement.publics], dtype=np.uint64), device)
            q = evaluate_quotient(air, dom, *lde, log_d, r[-1], pubs, r[:-1], vals)
            return [aux, vals, q]

        got, want = run(dev), run("cpu")
        for a, b in zip(got, want):
            if max_abs_err(a.reshape(-1), b.reshape(-1)):
                raise AssertionError(f"{type(air).__name__}: card and CPU aux traces or quotients differ")
        checked.append(f"{type(air).__name__} (2^{log_n} rows, aux {tuple(got[0].shape)}, "
                       f"quotient {got[2].shape[0]} points)")
    return ", ".join(checked)


def session_phase(torch, kernels, dev: str, pinned) -> tuple:
    """Phase 6: the pinned sessions (a), then the stdlib program's main proof
    and its deferred session on the card (b). ``pinned`` maps a session name
    of ``bench_session`` to the SHA-256 its proof bytes must have. Returns
    the session proof's launches and launch shapes per kernel entry."""
    from miden_tpu_torch import bench_session as BS
    from miden_tpu_torch.precompile import session as S
    from miden_tpu_torch.stark import MIDEN_PARAMS, TEST_PARAMS, VerificationError
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.utils.tracing import Recorder
    from miden_tpu_torch.vm import native_trace
    from miden_tpu_torch.vm.prove import prove_program, verify_program

    # -- (a) the pinned sessions ------------------------------------------
    for name in BS.PINNED:
        claims = BS.claims(getattr(BS, name))
        t0 = time.perf_counter()
        pr = S.prove_deferred_state(claims, TEST_PARAMS, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        S.verify_deferred(pr, S.deferred_root_for(claims), TEST_PARAMS)
        digest = BS.proof_digest(pr)
        # the bytes of the sessions with keccak or EC claims are the data of
        # tests/test_torch_precompile_card.py (a CPU proof of them takes hours)
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{name}.mtpu"), "wb") as fh:
            fh.write(proof_to_bytes(pr.stark))
        if digest != pinned[name]:
            raise AssertionError(f"{name}: card proof sha256 {digest}, pinned {pinned[name]}")
        log(f"  {name}: {len(claims)} claims, log heights {pr.stark.log_heights}, proved in "
            f"{secs:.3f} s, sha256 {digest} == pinned, verified")
    t0 = time.perf_counter()
    log(f"  card == CPU on MIXED_SESSION's traces, aux trace and quotient: {session_airs_card_vs_cpu(torch, dev)} "
        f"({time.perf_counter() - t0:.3f} s)")
    log_phase("phase 6a pinned sessions at TEST_PARAMS: card bytes == pinned bytes; keccak and EC AIRs "
              "card == CPU")

    # -- (b) the stdlib program and its session ---------------------------
    src, top = BS.stdlib_session_program()
    prog = assemble_with_stdlib(src)
    native_trace.RUNS.update({k: 0 for k in native_trace.RUNS})
    t0 = time.perf_counter()
    out, proof = prove_program(prog, params=MIDEN_PARAMS, event_handlers=stdlib_event_handlers(), device=dev)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    runs = dict(native_trace.RUNS)
    if [int(v) for v in out.stack[:8]] != top:
        raise AssertionError("the program's merge path root differs from the host's keccak256")
    verify_program(proof, params=MIDEN_PARAMS, partial=True)
    try:
        verify_program(proof, params=MIDEN_PARAMS)
    except VerificationError:
        pass
    else:
        raise AssertionError("a main proof with a deferred root verified without its session")
    t0 = time.perf_counter()
    claims = S.claims_from_deferred_state(out.deferred_state)
    traces = S.build_session_traces(claims)
    build_s = time.perf_counter() - t0
    kinds = {}
    for c in claims:
        kinds[type(c).__name__] = kinds.get(type(c).__name__, 0) + 1
    log(f"  program: {kinds} claims; main proof {main_s:.3f} s (log heights "
        f"{proof.stark.log_heights}, {len(proof.to_bytes())} bytes); the C trace generator wrote "
        f"{runs['rows']} core rows in {runs['block']} blocks, {100 * runs['rows'] / out.clk:.1f} % of "
        f"the {out.clk} cycles; partial verify accepts, "
        f"verify without the session rejects")
    log(f"  session trace build (claims_from_deferred_state + build_session_traces): {build_s:.3f} s; "
        + ", ".join(f"{f} {tuple(getattr(traces, f).shape)}" for f in
                    ("chain", "u256", "rng", "perm", "keccak", "kvar", "sponge", "ec_op", "ec_mac")
                    if getattr(traces, f) is not None))

    log(f"  host launch cost before the session proofs: {BS._launch_us(torch):.2f} us a one-element add")
    # the warm-up is the traced proof: spans synchronize at their edges, so
    # a traced call is never a timed one
    t0 = time.perf_counter()
    with Recorder() as rec:
        S.prove_deferred_state_dag(out.deferred_state, MIDEN_PARAMS, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, session = [], None
    session_shapes = {name: {} for name in kernels}
    for rep in range(2):
        if rep == 0:
            zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session = S.prove_deferred_state_dag(out.deferred_state, MIDEN_PARAMS, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            session_launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
            record_shapes(kernels, session_shapes)
    peak = torch.cuda.max_memory_allocated()
    if tuple(session.root) != tuple(proof.deferred_root):
        raise AssertionError("the session root is not the main proof's deferred root")
    t0 = time.perf_counter()
    S.verify_deferred(session, proof.deferred_root, MIDEN_PARAMS)
    verify_s = time.perf_counter() - t0
    verify_program(proof, params=MIDEN_PARAMS, deferred=session)
    bad_root = (proof.deferred_root[0] ^ 1, *proof.deferred_root[1:])
    try:
        S.verify_deferred(session, bad_root, MIDEN_PARAMS)
    except VerificationError:
        pass
    else:
        raise AssertionError("a session verified against a tampered root")
    if not all(session_launches.values()):
        raise AssertionError(f"a kernel was not launched on the session proof: {session_launches}")
    airs = [type(a).__name__ for a in S._session_statement(
        session.root, session.n_claims, session.n_u256, session.n_kmerge, session.n_ec).multi_air.airs]
    log("  session AIRs and log heights: " + ", ".join(
        f"{a} {h}" for a, h in zip(airs, session.stark.log_heights)))
    log("  spans (traced warm-up session proof, synchronized at span edges): " + "; ".join(
        f"{k} {v[0]:.4f} s" for k, v in rec.totals.items()))
    for span_name in ("evaluate constraints", "aux trace of one AIR"):
        log(f"  {span_name}, per AIR: " + ", ".join(
            f"{air} {v[0]:.4f} s" for (name, air), v in rec.by_air.items() if name == span_name))
    log(f"  launches per session proof: {session_launches}")
    log_phase(f"phase 6b session of {len(claims)} claims at MIDEN_PARAMS: prove_deferred_state_dag "
              f"{', '.join(f'{t:.4f}' for t in times)} s (traced warm-up {warm_s:.3f} s; trace build "
              f"{build_s:.3f} s of each), peak memory {peak / 2**30:.3f} GiB, proof "
              f"{len(proof_to_bytes(session.stark))} bytes, verify_deferred {verify_s:.3f} s; "
              f"verify_program(proof, deferred=session) accepts, tampered root rejected")
    return session_launches, session_shapes


def kernel_rows(torch, kernels, proofs, errs, rand) -> list:
    """Holds each kernel against its plain twin on random inputs at every
    shape the proofs launched it with (the shaped proof's traces are zeros,
    so its launches alone would not show the kernels right there), times
    it there, and returns one JSON row per entry: its largest shape on the
    VM proof (the main path) with bound and plain time, and its launches and
    ms per proof of each kind. ``proofs``: kind -> (launches, shapes) for
    "vm", "shaped" and "session"."""
    from miden_tpu_torch.bench_kernels import HBM_BYTES_PER_S, bench_case, bound_ms, time_ms
    from miden_tpu_torch.hash import poseidon2
    from miden_tpu_torch.ntt import ntt

    mul_rate = int32_mul_rate(torch)
    rows = []
    for name, (kern, source, replaces) in kernels.items():
        per_proof = {kind: 0.0 for kind in proofs}
        keys = sorted(set().union(*(shapes[name] for _, shapes in proofs.values())))
        top = None
        for key in keys:
            bench = bench_case(ntt, poseidon2, rand, name, key)
            errs[name] = max(errs[name], max_abs_err(bench["kernel"](), bench["plain"]()))
            ms = time_ms(bench["kernel"], bench["reps"])
            counts = {kind: shapes[name].get(key, 0) for kind, (_, shapes) in proofs.items()}
            for kind, count in counts.items():
                per_proof[kind] += ms * count
            if name == "ntt_col_transform":
                k_bound = bound_ms(bench, mul_rate)
                log(f"    {name} at {key}: {ms:.4f} ms/launch x " + " / ".join(
                    f"{c} ({kind})" for kind, c in counts.items()
                ) + f", bound {k_bound:.4f} ms ({100 * k_bound / ms:.1f} % of bound)")
            # the row reports the largest shape of the VM proof, the main path
            if counts["vm"] and (top is None or bench["elems"] > top[1]["elems"]):
                top = (key, bench, ms, counts["vm"])
        log(f"  {name}: kernel == plain at all {len(keys)} shapes of the proofs, max |diff| {errs[name]}")
        if errs[name]:
            raise AssertionError(f"{name} disagrees with its plain version at the proofs' shapes")
        key, bench, ms, count = top
        plain_ms = time_ms(bench["plain"], 2)
        b_ms = bound_ms(bench, mul_rate)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": proofs["vm"][0][name], "max_abs_err": errs[name],
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6), "bound_ms": round(b_ms, 6),
            "bound_by": "bytes" if bench["bytes"] / HBM_BYTES_PER_S >= bench["ops"] / mul_rate
            else "operations",
            "library_ms": None, "shape": list(key), "launches_at_shape": count,
            "ms_per_vm_proof": round(per_proof["vm"], 6),
            "launches_shaped": proofs["shaped"][0][name],
            "ms_per_shaped_proof": round(per_proof["shaped"], 6),
            "launches_session": proofs["session"][0][name],
            "ms_per_session_proof": round(per_proof["session"], 6),
        }
        if "copy" in bench:  # the bare transpose copy, a yardstick for K2
            row["copy_ms"] = round(time_ms(bench["copy"], bench["reps"]), 6)
        rows.append(row)
        log(f"  {name} at {key}: {ms:.4f} ms/launch (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {row['bound_by']}); per proof: " + "; ".join(
                f"{kind} {proofs[kind][0][name]} launches over {len(proofs[kind][1][name])} shapes, "
                f"{per_proof[kind]:.3f} ms" for kind in proofs))
    return rows


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from miden_tpu_torch.bench_airs import miden_shaped_statement
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.field import goldilocks as F
    from miden_tpu_torch.hash import poseidon2
    from miden_tpu_torch.ntt import ntt
    from miden_tpu_torch.stark import MIDEN_PARAMS, prove, verify
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.transcript.challenger import DuplexChallenger
    from miden_tpu_torch.utils import cuda
    from miden_tpu_torch.utils.tracing import Recorder
    from miden_tpu_torch import native
    from miden_tpu_torch.vm import assemble, native_trace
    from miden_tpu_torch.vm.prove import prove_program, verify_program
    from miden_tpu_torch.vm.trace import execute_and_trace

    card = nvidia_smi("name,power.limit")
    kernels = kernel_table()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; host "
        f"{os.cpu_count()} CPUs, load average {os.getloadavg()[0]:.2f}")

    # -- 1. build ------------------------------------------------------------
    secs = cuda.build_all()
    for name in ("ntt", "poseidon2"):
        ptxas = [
            ln.strip() for ln in (cuda.BUILD_DIR / f"{name}.log").read_text().splitlines()
            if "registers" in ln or "spill" in ln
        ]
        log(f"  ptxas {name}: " + " | ".join(ptxas))
    t0 = time.perf_counter()
    native.trace_gen_lib()
    log_phase(f"phase 1 build: {secs:.3f} s for csrc/ntt.cu and csrc/poseidon2.cu, "
        f"{time.perf_counter() - t0:.3f} s for native/trace_gen.c ({native.LIBRARY.name})")
    from miden_tpu_torch.bench_session import _launch_us

    log(f"  host launch cost: {_launch_us(torch):.2f} us a one-element add")

    # -- 2. kernels against their plain twins -------------------------------
    rng = np.random.default_rng(2024)
    dev = "cuda"

    def rand(shape):
        return F.to_torch(rng.integers(0, gl.P, size=shape, dtype=np.uint64), dev)

    errs = {k: 0 for k in kernels}
    checked = {k: 0 for k in kernels}
    for n in (1, 1000, 1 << 16):
        s = rand((12, n))
        errs["poseidon2_permute"] = max(
            errs["poseidon2_permute"], max_abs_err(poseidon2.permute_kernel(s), poseidon2.permute_plain(s))
        )
        checked["poseidon2_permute"] += 1
    for max_h, h, w in ((1, 1, 3), (256, 64, 51), (1 << 14, 1 << 12, 22), (1 << 12, 1 << 12, 130)):
        s, m = rand((12, max_h)), rand((h, w))
        err = max_abs_err(poseidon2.absorb_rows_kernel(s, m), poseidon2.absorb_rows_plain(s, m))
        errs["poseidon2_absorb_rows"] = max(errs["poseidon2_absorb_rows"], err)
        checked["poseidon2_absorb_rows"] += 1
    for m in (1, 1000, 1 << 15):
        cur = rand((2 * m, 4))
        err = max_abs_err(poseidon2.compress_rows_kernel(cur), poseidon2.compress_rows_plain(cur))
        errs["poseidon2_compress_rows"] = max(errs["poseidon2_compress_rows"], err)
        checked["poseidon2_compress_rows"] += 1
    for log_n in range(1, ntt.MAX_LOG_SINGLE + 1):
        for width in (1, 3, 51, 130):
            x = rand((1 << log_n, width))
            for dit in (False, True):
                for inverse in (False, True):
                    got = ntt.col_transform_kernel(x, inverse, dit)
                    errs["ntt_col_transform"] = max(
                        errs["ntt_col_transform"], max_abs_err(got, ntt.transform_plain(x, inverse, dit))
                    )
                    checked["ntt_col_transform"] += 1
    for a, b, w in ((64, 32, 5), (1024, 2048, 51), (2048, 1024, 16)):
        x = rand((a, b, w))
        for mode in (0, 1, 2):
            tw = rand((a, b) if mode == 1 else (b, a))
            err = max_abs_err(ntt.transpose_twiddle_kernel(x, tw, mode), ntt.transpose_twiddle_plain(x, tw, mode))
            errs["ntt_transpose_twiddle"] = max(errs["ntt_transpose_twiddle"], err)
            checked["ntt_transpose_twiddle"] += 1
    for log_n in range(11, 22):
        x = rand((1 << log_n, 16))
        for dit in (False, True):
            for inverse in (False, True):
                fast = ntt.four_step_dit if dit else ntt.four_step_dif
                err = max_abs_err(fast(x, inverse), ntt.transform_plain(x, inverse, dit))
                errs["ntt_transpose_twiddle"] = max(errs["ntt_transpose_twiddle"], err)
                checked["ntt_transpose_twiddle"] += 1
    torch.cuda.synchronize()
    for name, (kern, _, _) in kernels.items():
        log(f"  {name}: {checked[name]} comparisons, {kern.launches} launches, max |diff| {errs[name]}")
    if any(errs.values()):
        raise AssertionError(f"kernel disagrees with its plain version: {errs}")
    log_phase("phase 2 kernels vs plain: all equal (tolerance 0: Goldilocks arithmetic is exact)")

    # -- 3. small proof, card vs CPU ----------------------------------------
    st, tr = miden_shaped_statement(SMALL_LOG, device=dev)
    out_gpu = prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev)
    st_c, tr_c = miden_shaped_statement(SMALL_LOG, device="cpu")
    t0 = time.perf_counter()
    out_cpu = prove(MIDEN_PARAMS, st_c, tr_c, DuplexChallenger(SEED), device="cpu")
    cpu_s = time.perf_counter() - t0
    b_gpu, b_cpu = proof_to_bytes(out_gpu.proof), proof_to_bytes(out_cpu.proof)
    if b_gpu != b_cpu:
        raise AssertionError("card and CPU proofs differ")
    if verify(MIDEN_PARAMS, st, out_gpu.proof, DuplexChallenger(SEED)) != out_gpu.digest:
        raise AssertionError("verifier digest differs from the prover's")
    log_phase(f"phase 3 small proof 2^{SMALL_LOG} MIDEN_PARAMS: card == CPU ({len(b_gpu)} bytes), "
        f"verified; CPU prove {cpu_s:.3f} s")

    # -- 4. full-size proof -------------------------------------------------
    shapes = {name: {} for name in kernels}  # shaped-18 proof: shape -> launches
    vm_shapes = {name: {} for name in kernels}  # VM proof (phase 5b)

    st, tr = miden_shaped_statement(FULL_LOG, device=dev)
    t0 = time.perf_counter()
    prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # one timed prove: the VM proof of phase 5 is the main path now, and
    # this phase gives up its repeats and its profile to keep the script
    # inside half its time limit
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev)
    stop.record()
    torch.cuda.synchronize()
    prove_s = start.elapsed_time(stop) / 1e3
    launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
    record_shapes(kernels, shapes)
    peak = torch.cuda.max_memory_allocated()
    with Recorder() as rec:
        prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev)
    t0 = time.perf_counter()
    digest = verify(MIDEN_PARAMS, st, out.proof, DuplexChallenger(SEED))
    verify_s = time.perf_counter() - t0
    if digest != out.digest:
        raise AssertionError("full-size proof rejected")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    log("  spans (traced prove, synchronized at span edges): " + "; ".join(
        f"{k} {v[0]:.4f} s" for k, v in rec.totals.items()
    ))
    log(f"  launches per proof: {launches}")
    log("  poseidon2_permute launches per proof by n: " + ", ".join(
        f"{key[0]}: {count}" for key, count in sorted(shapes["poseidon2_permute"].items())
    ))
    log_phase(f"phase 4 full proof 2^{FULL_LOG} MIDEN_PARAMS: {prove_s:.4f} s (one timed prove; "
        f"warm-up {warm_s:.3f} s), "
        f"peak memory {peak / 2**30:.3f} GiB, proof {len(proof_to_bytes(out.proof))} bytes, "
        f"verified in {verify_s:.3f} s")

    # -- 5. the VM facade: prove_program / verify_program --------------------
    small = assemble(fib_program(VM_SMALL_REPS))
    out_gpu, vm_gpu = prove_program(small, params=MIDEN_PARAMS, device=dev)
    t0 = time.perf_counter()
    _, vm_cpu = prove_program(small, params=MIDEN_PARAMS, device="cpu")
    cpu_s = time.perf_counter() - t0
    if vm_gpu.to_bytes() != vm_cpu.to_bytes():
        raise AssertionError("VM proofs from the card and the CPU differ")
    verify_program(vm_gpu, params=MIDEN_PARAMS)
    if out_gpu.stack[0] != fib_top(VM_SMALL_REPS, gl.P):
        raise AssertionError(f"small VM program left {out_gpu.stack[0]} on top of the stack")
    log_phase(f"phase 5a VM fib repeat.{VM_SMALL_REPS} MIDEN_PARAMS: card == CPU "
        f"({len(vm_gpu.to_bytes())} bytes), log heights {vm_gpu.stark.log_heights}, verified; "
        f"CPU prove {cpu_s:.3f} s")

    full = assemble(fib_program(VM_FULL_REPS))
    t0 = time.perf_counter()
    prove_program(full, params=MIDEN_PARAMS, device=dev)
    torch.cuda.synchronize()
    vm_warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    vm_times, vm_out, vm_proof = [], None, None
    for rep in range(3):
        if rep == 0:
            zero_counts(kernels)
            native_trace.RUNS.update({k: 0 for k in native_trace.RUNS})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vm_out, vm_proof = prove_program(full, params=MIDEN_PARAMS, device=dev)
        torch.cuda.synchronize()
        vm_times.append(time.perf_counter() - t0)
        if rep == 0:
            vm_launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
            record_shapes(kernels, vm_shapes)
            native_runs = dict(native_trace.RUNS)
    vm_peak = torch.cuda.max_memory_allocated()
    trace_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, vm_trace = execute_and_trace(full)
        trace_times.append(time.perf_counter() - t0)
    with Recorder() as vm_rec:
        prove_program(full, params=MIDEN_PARAMS, device=dev)
    t0 = time.perf_counter()
    verify_program(vm_proof, params=MIDEN_PARAMS)
    vm_verify_s = time.perf_counter() - t0
    want_top = fib_top(VM_FULL_REPS, gl.P)
    if vm_out.stack[0] != want_top:
        raise AssertionError(f"VM program left {vm_out.stack[0]}, fib mod p is {want_top}")
    if not all(vm_launches.values()):
        raise AssertionError(f"a kernel was not launched on the VM proof: {vm_launches}")
    # (c) the core rows came from the C trace generator, not the interpreter
    c_share = native_runs["rows"] / vm_trace.num_real_rows
    if native_runs["block"] == 0 or c_share < 0.99:
        raise AssertionError(f"the VM trace did not come from the C trace generator: {native_runs}")
    med, med_trace = statistics.median(vm_times), statistics.median(trace_times)
    log("  spans (traced prove_program, synchronized at span edges): " + "; ".join(
        f"{k} {v[0]:.4f} s" for k, v in vm_rec.totals.items()
    ))
    log(f"  launches per VM proof: {vm_launches}")
    log(f"  host load average after the timed calls: {os.getloadavg()[0]:.2f} over {os.cpu_count()} CPUs")
    log(f"  C trace generator: {native_runs['block']} blocks, {native_runs['rows']} of "
        f"{vm_trace.num_real_rows} real core rows ({100 * c_share:.3f} %)")
    log_phase(f"phase 5b VM fib repeat.{VM_FULL_REPS} MIDEN_PARAMS: log heights {vm_proof.stark.log_heights} "
        f"(core, chiplets, poseidon); prove_program median {med:.4f} s (runs "
        f"{', '.join(f'{t:.4f}' for t in vm_times)}; warm-up {vm_warm_s:.3f} s), execute_and_trace "
        f"median {med_trace:.4f} s ({100 * med_trace / med:.1f} % of the call; runs "
        f"{', '.join(f'{t:.4f}' for t in trace_times)}), peak memory {vm_peak / 2**30:.3f} GiB, "
        f"proof {len(vm_proof.to_bytes())} bytes, verified in {vm_verify_s:.3f} s, top of stack "
        f"{vm_out.stack[0]} == fib mod p")

    # -- 6. the precompile session ---------------------------------------------
    from miden_tpu_torch import bench_session

    session_launches, session_shapes = session_phase(torch, kernels, dev, bench_session.PINNED)

    # -- 7. kernels vs plain, and timings, at the proofs' shapes --------------
    rows = kernel_rows(torch, kernels, {
        "vm": (vm_launches, vm_shapes), "shaped": (launches, shapes),
        "session": (session_launches, session_shapes),
    }, errs, rand)
    log_phase(f"phase 7 kernels vs plain and timings at the proofs' shapes on {card}")

    # -- 8. device-busy share, then the result lines ---------------------------
    # the profiler runs last: after it the host's cost per launch stays up
    # (on an H100 80GB HBM3 host, 8.19 -> 13.59 us a one-element add) and
    # the session proof is 25-40 % slower (python3 -m miden_tpu_torch.bench_session)
    vm_busy = device_busy(torch, lambda: prove_program(full, params=MIDEN_PARAMS, device=dev))
    log_phase(f"phase 8 profiled prove_program of VM fib repeat.{VM_FULL_REPS}: {vm_busy}")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
