#!/usr/bin/env python3
"""Smoke run of the PyTorch port (miden_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (plus details):

1. build the CUDA kernels from miden_tpu_torch/csrc (one nvcc per source,
   in parallel) and the C trace generator (miden_tpu_torch/native);
2. hold each kernel entry (K1 ntt_col_transform, K2 ntt_transpose_twiddle,
   K3 poseidon2_permute, poseidon2_absorb_rows, poseidon2_compress_rows, the
   same three entries of R1 RPO-256 and R2 RPX-256, and Q1 constraints_eval,
   the recorded constraint program of stark/interp.py) against its plain
   torch twin on the card, exact equality, on inputs from a seeded
   generator (Q1: the chiplets and Poseidon2 VM AIRs and an AIR with
   preprocessed columns over 2^12 points, reading row-strided views), and
   R1 / R2's entries also
   on states of edge values (hash.rescue.hold_edge_states) against the
   twin and rescue_host;
3. prove miden_shaped_statement(10) at MIDEN_PARAMS on the card and on the
   CPU: the proof bytes must be equal and the port's verifier must accept;
4. prove miden_shaped_statement(18) at MIDEN_PARAMS on the card, eagerly
   (fused=False; core
   2^18 x 51 with 8 EF aux columns, chiplets 2^16 x 22, perm 2^14 x 16, LDE
   2^21 rows): one warm-up, one timed prove (CUDA events), its kernel
   launch counts (per entry, and K3's permutations per shape), the span
   breakdown of one traced prove, peak memory, and the verifier's verdict;
5. the VM facade, the port's main path: (a) prove_program of the fib
   program (repeat.10) at MIDEN_PARAMS on the card and on the CPU, proof
   bytes equal and verify_program accepting; (b) the fib program with
   repeat.84000 (core 2^18 rows, bench.py's real-program row) at
   MIDEN_PARAMS through the fused prover (stark/fused.py), the card's
   default: the warm-up (the shape's first proof, its phases run eagerly;
   its bytes are the reference), the capture call (the five phases captured
   into CUDA graphs and replayed), timed apart, and three timed replays
   (host clock around the whole call, as bench.py times it), each equal to
   the warm-up's bytes; execute_and_trace's time beside them, the AIRs' log
   heights, the kernel launch counts of a replayed proof (equal to the
   warm-up's; every entry of the path must be launched, and no other; a
   replay counts the launches of its capture once the graph's kernel nodes,
   read back from it, were found to be those launches), the
   span breakdown of one traced eager prove (fused=False; "evaluate
   constraints" per AIR too) and of one traced replay (a span a phase), each
   phase's graph nodes, capture, node read and instantiate seconds, the eager and the
   fused peak memory, the proof size, verify_program's verdict and the top
   of the stack against fib mod p; on the warm-up's inputs, each VM AIR's
   quotient through Q1 equals the eager evaluator's over its whole domain
   (the core's 2^21 points);
   (c) the trace of (b) was written by the C trace generator, not the
   Python interpreter;
   5c. the same facade under PcsParams(hash_name="rpo256" | "rpx256"), whose
   trees R1 / R2 build: the fib program (repeat.10) card == CPU and
   verified under each; vm-fib-18-rpo256 and -rpx256 (the program of (b))
   on the default path: the warm-up (eager; traced for rpo256), the
   capture call and one replay of the phases' graphs, timed, each equal
   to the warm-up's bytes, the replay's launches equal to the warm-up's
   (R1 / R2 among them), each phase's graph, verified;
   5d. bench_airs.square_lut_statement, an AIR with preprocessed columns,
   at MIDEN_PARAMS: card == CPU at 2^10 rows, one proof at 2^18 rows on
   the card, verified against its preprocessed commitment;
   5e. a second program of (b)'s log heights (fib repeat.83999 on stack
   inputs [3, 5]: another program hash, other publics), proved eagerly
   (fused=False) and then replayed through (b)'s graphs: the bytes equal,
   and the replayed proof verifies;
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
   session proof (the first of its shape: eager), its seconds, the
   trace-build time, the AIRs' log
   heights, launches, spans, peak memory, proof size, and
   verify_program(proof, deferred=session) accepting where a tampered root
   and a missing session are rejected;
10. the MASM standard library (``miden_tpu_torch.bench_stdlib``): (a)
   stdlib-small, the u64 program of tests/test_stdlib.py (u64 mul, add,
   divmod through the u64_div handler, sys::truncate_stack), at MIDEN_PARAMS
   on the card and on the CPU, bytes equal; (b) stdlib-blake3-18, the
   reference's blake3_1to1 benchmark program (28 blake3::hash_1to1 calls,
   252,138 cycles, log heights [18, 18, 13]: the first full-height chiplets
   AIR) at MIDEN_PARAMS: a traced warm-up and one timed prove_program call
   (eager: fused=False),
   the execute_and_trace span, launches, peak memory, proof size, the digest
   against 28 host BLAKE3s, verified, and the chiplets and Poseidon2 AIRs'
   LogUp aux traces card == CPU at full height; (c) stdlib-host, one
   program through mem, word, u128, sorted_array, mmr, smt, sha256,
   poseidon2 and an aead round trip, proved on the card, outputs equal to
   the host's, verified;
   (d) MerkleTree over 2^16 seeded leaves on the card (K3 compress_rows),
   every layer equal to the CPU's;
11. the in-VM STARK verifier (``miden_tpu_torch.bench_recursion``), the
   recursion step: (a) the recursion fixture of 5(b)'s vm-fib-18 proof
   (``stdlib.recursion.extract_recursion_fixture``); (b) the full transcript
   replay (every challenge by the in-VM random coin, then per query the
   DEEP quotient, the FRI fold chain through FRIE2F4 and the final
   polynomial) and the OOD identity (each AIR's constraint fold checked by
   its registry-authenticated ACE circuit) executed in the VM on it, the
   replay's (z, alpha_deep, beta_deep) equal to the fixture's, and a circuit
   blob with one bit flipped refused; (c) recursion-18: the replay program
   (304,048 cycles) proved on the card at MIDEN_PARAMS with its launches,
   heights, trace-build span, C trace share and peak memory, and verified;
   (d) the fib repeat.40 proof at TEST_PARAMS: both programs executed on its
   fixture, and fri_query_program proved on the card and on the CPU, bytes
   equal;
12. multi-device proving (``miden_tpu_torch.dist``, ``bench_dist``): (a) the
   program of 5(b) through prove_program under use_mesh(make_mesh("cuda")),
   an NCCL group of world size 1 (NCCL refuses two ranks on one card), on
   the fused path: the eager warm-up, the capture call (each phase captured
   with its NCCL collectives) and a replay, each call's bytes equal to
   5(b)'s, the graphs' kernel nodes held to the capture's launches; (d) on
   4 gloo ranks sharing the card (spawned after the build, loading its
   libraries): prove_sharded of that program, every rank's bytes equal to
   5(b)'s, its peak allocated memory below 5e's one-device eager peak, the
   bytes it holds of the max-height tensors at the end of stage_open a
   quarter of one device's (each a RowShard), the bytes each collective
   moved, its K1 / K2 / K3 / Q1 launches, Q1 held to its twin at the block
   and halo it ran, and the sharded commit of vm-fib-18's main trace
   shapes (random values) against one device's; (c) on 2 of those ranks,
   prove_program of the program of 5(a) under their mesh: both ranks'
   bytes equal 5(a)'s CPU bytes. The shapes the kernels launched with in
   (a)'s replay, (d) and (c) join phase 7's;
7. hold each kernel against its plain twin and time it, with its bound, at
   every shape phases 4, 5(b), 5c, 6(b), 10(b), 11(c) and 12 launched it with (5(b) and 5c: a
   replay's shapes; K1 printed at
   each shape; a sponge entry over every state of a launch, or over 2^14
   states spread over it where the plain twin would take more than 30 s),
   with its time per proof of each kind; R1 / R2's permute entries, which no
   proof launches, at n = 2^16. Q1 is held on the proofs' own inputs
   instead (ProgramChecks): at every (AIR, points) shape any proof of the
   script launched it with, right after the first run at that shape, over
   every point (2^14 spread points where the twin would take over 30 s),
   timed there; phase 7 sums its launches and ms per proof of each kind;
9. the user entry surfaces on the card: (a) the command line on the program
   of 5(b): ``python -m miden_tpu_torch`` compile -o, run, prove -o (on
   the card, its wall time printed) and verify, each in a subprocess; the
   written proof bytes equal 5(b)'s proof, verify exits 0 and exits 1 on a
   proof with one flipped byte, the compiled bytes decode to the program's
   digest (compile and run side by side, verify beside the flipped
   proof's verify, prove alone); then the CLI's prove once in this process,
   with the kernel counts set to 0 just before it and read just after (the
   path's every entry launched, and no other); (b), which runs before (a),
   the fib program (repeat.10) through
   the MAST wire form and through a ``.masp`` package, each decoded
   program proved on the card to 5(a)'s CPU bytes; (c) pause/resume of the
   program of 5(b), a budget of 2^16 cycles and resumed by 2^16 until it
   finishes, its stack and clk equal to one uninterrupted execution; (d)
   the BLAKE3-256 and Keccak-256 LMCS trees over random matrices of the
   VM's LDE shapes, (2^21, 51) and (2^16, 24), committed on the card,
   opened at 27 queries and verified on the host, with card == CPU roots
   at (2^10, 51) and (2^6, 24);
8. the device-busy share of one more VM fib-18 prove_program under
   torch.profiler, a replay of its graphs (after the shape's warm-up and
   capture; last on the card: after the profiler every launch costs
   the host more), and the port's kernels among the device's events of
   that replay, per entry, equal to 5(b)'s eager warm-up's launches; the
   JSON line of kernels, the card's name and power
   limit, and the result line ``{"ok": true, "device": {...}}`` last.

The CPU halves of the card == CPU checks (phases 3, 5a, 5c, 5d, 6a's
session AIRs, 10a, 10b's aux traces (with the program's execution), 10d,
11d) are made in one spawned process of their own (CpuHalves, CPU_THREADS
torch threads), queued right after the build, while the card works; each
phase waits for its bytes where it compares them.

Any failure raises and the script exits non-zero without a result line. It
needs one CUDA device, and the repository around it.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
#: phase 5e: another program of vm-fib-18's log heights, other stack inputs
VM_OTHER_REPS, VM_OTHER_INPUTS = 83999, [3, 5]
PP_SMALL_LOG, PP_FULL_LOG = 10, 18  # rows of the preprocessed statement


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


def max_abs_err(a, b) -> int:
    """Largest |a − b| over the u64 values (0 when equal)."""
    from miden_tpu_torch.field.goldilocks import to_numpy

    x, y = to_numpy(a), to_numpy(b)
    bad = x != y
    if not bad.any():
        return 0
    return max(abs(int(u) - int(v)) for u, v in zip(x[bad], y[bad]))


def device_busy(torch, fn) -> tuple:
    """One run of ``fn`` under torch.profiler: device time (kernels, copies,
    fills) against wall time, and the kernels that take the most device
    time; and ``{kernel entry: launches}``, the port's kernels among the
    device's events (by their device function's name,
    ``cuda.kernel_named``). Only device activity is traced. The device's events are read
    straight from kineto's results: the profiler's Python event tree
    (``key_averages``) for the ~600k launches of a VM proof took minutes,
    and its Chrome trace is slower to write and read back than these
    events are to sum."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from miden_tpu_torch.utils.cuda import kernel_named

    sums: dict = {}
    on_card = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == on_card:
            entry = sums.setdefault(ev.name(), [0, 0])
            entry[0] += ev.duration_ns()
            entry[1] += 1
    launches: dict = {}
    for name, (_ns, count) in sums.items():
        kernel = kernel_named(name)
        if kernel is not None:
            launches[kernel.symbol] = launches.get(kernel.symbol, 0) + count
    if not sums:
        return f"wall {wall:.4f} s under the profiler; device time not measured (no device events)", launches
    rows = sorted(((ns, k, c) for k, (ns, c) in sums.items()), reverse=True)
    total = sum(r[0] for r in rows) / 1e9
    top = "; ".join(f"{k.removeprefix('void ').removeprefix('at::native::')[:100]} {ns / 1e6:.2f} ms x{c}"
                    for ns, k, c in rows[:8])
    return (f"wall {wall:.4f} s under the profiler, device busy {total:.4f} s "
            f"({100 * total / wall:.1f} %); top: {top}"), launches


def kernel_table() -> dict:
    """Kernel entry -> (its cuda.Kernel, source, the TPU kernel it replaces)."""
    from miden_tpu_torch.hash import poseidon2, rescue
    from miden_tpu_torch.ntt import ntt
    from miden_tpu_torch.stark import interp

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
        # R1 and R2 are the port's own: miden_tpu computes them in XLA, with no
        # Pallas kernel (rescue.py:180 rpo_permute, :215 rpx_permute)
        **{f"{perm}_{entry}": (getattr(sponge, attr), "miden_tpu_torch/csrc/rescue.cu",
                               f"miden_tpu/hash/rescue.py:{line}")
           for perm, sponge, line in (("rpo", rescue.RPO, 180), ("rpx", rescue.RPX, 215))
           for entry, attr in (("permute", "PERMUTE_KERNEL"), ("absorb_rows", "ABSORB_KERNEL"),
                               ("compress_rows", "COMPRESS_KERNEL"))},
        # Q1 runs the recorded constraint program, which miden_tpu runs as an
        # XLA lax.scan (interp.py:273 _run_chunk), with no Pallas kernel
        Q1: (interp.Q1_KERNEL, "miden_tpu_torch/csrc/constraints.cu", "miden_tpu/stark/interp.py:273"),
    }


#: the name of Q1, the recorded constraint program, in the kernel table
Q1 = "constraints_eval"


def path_kernels(hash_name: str, program: bool = True) -> list:
    """The kernel entries a proof launches under commitment hash
    ``hash_name``: K1, K2 and K3's permute (the transcript is Poseidon2
    whatever the hash), the leaf sponge and Merkle layer of the hash, and
    Q1 where ``program``: some AIR of the proof goes through its recorded
    constraint program (every VM proof: :func:`routes_program`)."""
    leaf = {"poseidon2": "poseidon2", "rpo256": "rpo", "rpx256": "rpx"}[hash_name]
    return ["ntt_col_transform", "ntt_transpose_twiddle", "poseidon2_permute",
            f"{leaf}_absorb_rows", f"{leaf}_compress_rows"] + ([Q1] if program else [])


def routes_program(airs, log_heights) -> bool:
    """Whether a proof of ``airs`` at ``log_heights`` evaluates some AIR's
    quotient through its recorded program (Q1 on the card)."""
    from miden_tpu_torch.stark.domains import log_quotient_degree
    from miden_tpu_torch.stark.prover import uses_program

    return any(uses_program(a, 1 << h, log_quotient_degree(a.constraint_degree()))
               for a, h in zip(airs, log_heights))


def check_path(launches: dict, hash_name: str, what: str, program: bool = True) -> None:
    """Every entry of the path was launched, and no other."""
    path = path_kernels(hash_name, program)
    missing = [k for k in path if not launches[k]]
    stray = [k for k, n in launches.items() if n and k not in path]
    if missing or stray:
        raise AssertionError(f"{what}: entries of the path not launched {missing}, "
                             f"entries off the path launched {stray}: {launches}")


def zero_counts(kernels) -> None:
    for kern, _, _ in kernels.values():
        kern.launches = 0
        kern.shapes.clear()


def record_shapes(kernels, into) -> None:
    for name, (kern, _, _) in kernels.items():
        for key, count in kern.shapes.items():
            into[name][key] = into[name].get(key, 0) + count


def session_airs_card_vs_cpu(dev: str) -> str:
    """The three MIXED digests were minted on the card, so they show only
    that the card repeats itself. This holds the card to the CPU without a
    CPU proof (whose LMCS lift to the range table's 2^20-row LDE takes
    hours): on MIXED_SESSION's traces and publics, each of the keccak and EC
    AIRs builds its LogUp aux trace, and evaluates its quotient over the
    LDEs at TEST_PARAMS' blowup, on the card and on the CPU (the CPU
    process's job "session_airs"), from the same seeded randomness and α.
    Every output must be bit-equal."""
    from miden_tpu_torch.field import goldilocks as F

    got = session_air_outputs(dev)
    want, _ = CPU_HALVES.get("session_airs")
    checked = []
    for (name, log_n, outs), (_, _, wants) in zip(got, want):
        for a, b in zip(outs, wants):
            if not np.array_equal(F.to_numpy(a.reshape(-1)), b.reshape(-1)):
                raise AssertionError(f"{name}: card and CPU aux traces or quotients differ")
        checked.append(f"{name} (2^{log_n} rows, aux {tuple(outs[0].shape)}, quotient {outs[2].shape[0]} points)")
    return ", ".join(checked)


def session_air_outputs(dev: str) -> list:
    """[(AIR name, log rows, [aux, aux values, quotient])] of the keccak and
    EC AIRs on MIXED_SESSION's traces, on ``dev``."""
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

        checked.append((type(air).__name__, log_n, run(dev)))
    return checked


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
    log(f"  card == CPU on MIXED_SESSION's traces, aux trace and quotient: {session_airs_card_vs_cpu(dev)} "
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
    drain_program_checks()
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
    # one proof, traced, the first of its shape (eager): the spans' syncs cost
    # this host-bound proof nothing measurable (an H100 80GB HBM3 host: 32.797 s
    # traced, 33.4277 s untraced), and a second call would crowd the 1200 s limit
    torch.cuda.reset_peak_memory_stats()
    session_shapes = {name: {} for name in kernels}
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Recorder() as rec:
        session = S.prove_deferred_state_dag(out.deferred_state, MIDEN_PARAMS, device=dev)
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    session_launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
    record_shapes(kernels, session_shapes)
    peak = torch.cuda.max_memory_allocated()
    drain_program_checks()
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
    session_airs = S._session_statement(
        session.root, session.n_claims, session.n_u256, session.n_kmerge, session.n_ec).multi_air.airs
    check_path(session_launches, "poseidon2", "the session proof",
               program=routes_program(session_airs, session.stark.log_heights))
    airs = [type(a).__name__ for a in session_airs]
    log("  session AIRs and log heights: " + ", ".join(
        f"{a} {h}" for a, h in zip(airs, session.stark.log_heights)))
    log("  spans (the traced session proof, synchronized at span edges): " + "; ".join(
        f"{k} {v[0]:.4f} s" for k, v in rec.totals.items()))
    for span_name in ("evaluate constraints", "aux trace of one AIR"):
        log(f"  {span_name}, per AIR: " + ", ".join(
            f"{air} {v[0]:.4f} s" for (name, air), v in rec.by_air.items() if name == span_name))
    log(f"  launches per session proof: {session_launches}")
    log_phase(f"phase 6b session of {len(claims)} claims at MIDEN_PARAMS: prove_deferred_state_dag "
              f"{session_s:.4f} s (one traced call, the first of its shape; trace build "
              f"{build_s:.3f} s), peak memory {peak / 2**30:.3f} GiB, proof "
              f"{len(proof_to_bytes(session.stark))} bytes, verify_deferred {verify_s:.3f} s; "
              f"verify_program(proof, deferred=session) accepts, tampered root rejected")
    return session_launches, session_shapes


def graph_stats(plan) -> str:
    """Each captured phase's graph: nodes, kernel nodes of the port, and the
    seconds of its capture, node read and instantiation."""
    return "; ".join(
        f"{name} {st['nodes']} nodes ({st['launches']} kernel launches of the port), capture "
        f"{st['capture_s']:.4f} s, node read {st['read_s']:.4f} s, instantiate {st['instantiate_s']:.4f} s"
        for name, st in plan.phase_stats().items())


def rescue_phase(torch, kernels, dev: str) -> dict:
    """Phase 5c: the VM facade under the two other commitment hashes of
    PcsParams, rpo256 and rpx256 (kernels R1 and R2 build every tree): (a)
    the fib program (repeat.10) at MIDEN_PARAMS on the card and on the CPU,
    proof bytes equal and verify_program accepting; (b) vm-fib-18-rpo256, the
    program of phase 5b at MIDEN_PARAMS with hash_name="rpo256", and (c)
    vm-fib-18-rpx256, each on the default (fused) path: the warm-up (the
    shape's first proof, eager; traced for rpo256, its spans printed), the
    capture call and one replay, both timed and equal to the warm-up's
    bytes, the replay's launches equal to the warm-up's and on the path,
    each phase's graph, the eager and fused peak memory, verified. Returns
    {"vm_rpo" | "vm_rpx": (launches, launch shapes)} of the replay of each."""
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.stark import MIDEN_PARAMS, fused
    from miden_tpu_torch.utils.tracing import Recorder
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import prove_program, verify_program

    small, full = assemble(fib_program(VM_SMALL_REPS)), assemble(fib_program(VM_FULL_REPS))
    out = {}
    for hash_name, kind, traced in (("rpo256", "vm_rpo", True), ("rpx256", "vm_rpx", False)):
        params = dataclasses.replace(MIDEN_PARAMS, hash_name=hash_name)
        _, on_card = prove_program(small, params=params, device=dev)
        cpu_bytes, cpu_s = CPU_HALVES.get(f"vm_fib_{hash_name}")
        if on_card.to_bytes() != cpu_bytes:
            raise AssertionError(f"{hash_name}: VM proofs from the card and the CPU differ")
        verify_program(on_card, params=params)
        log(f"  {hash_name} fib repeat.{VM_SMALL_REPS}: card == CPU ({len(on_card.to_bytes())} bytes), "
            f"verified; CPU prove {cpu_s:.3f} s (in the CPU process)")
        # the warm-up: the shape's first proof, eager, its bytes the reference
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Recorder() if traced else contextlib.nullcontext() as rec:
            _, warm = prove_program(full, params=params, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        eager_peak = torch.cuda.max_memory_allocated()
        warm_launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
        if traced:
            log("  spans (traced warm-up prove_program, synchronized at span edges): " + "; ".join(
                f"{k} {v[0]:.4f} s" for k, v in rec.totals.items()))
        drain_program_checks()
        # the capture call, then one replay
        secs = []
        for rep in range(2):
            if rep == 0:
                torch.cuda.reset_peak_memory_stats()
            else:
                zero_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vm_out, proof = prove_program(full, params=params, device=dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if proof.to_bytes() != warm.to_bytes():
                raise AssertionError(f"vm-fib-18-{hash_name} call {rep} after the warm-up differs from its bytes")
            if rep == 0:
                fused_peak = torch.cuda.max_memory_allocated()
                plan = fused.cached_plan()
                if plan is None or not plan.captured:
                    raise AssertionError(f"the second vm-fib-18-{hash_name} proof did not capture its phases")
                graphs = graph_stats(plan)
                del plan  # release() frees the graphs only where nothing else holds them
        launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
        shapes = {name: {} for name in kernels}
        record_shapes(kernels, shapes)
        if launches != warm_launches:
            raise AssertionError(f"vm-fib-18-{hash_name}: a replay's launches {launches} != the warm-up's "
                                 f"{warm_launches}")
        check_path(launches, hash_name, f"vm-fib-18-{hash_name}")
        t0 = time.perf_counter()
        verify_program(proof, params=params)
        verify_s = time.perf_counter() - t0
        if vm_out.stack[0] != fib_top(VM_FULL_REPS, gl.P):
            raise AssertionError(f"{hash_name}: VM program left {vm_out.stack[0]} on top of the stack")
        log(f"  launches per vm-fib-18-{hash_name} proof (a replay; == the eager warm-up's): {launches}")
        log(f"  graphs: {graphs}")
        log_phase(f"phase 5c vm-fib-18-{hash_name} MIDEN_PARAMS: log heights {proof.stark.log_heights}; "
                  f"prove_program: the warm-up {warm_s:.4f} s (eager{', traced' if traced else ''}), the "
                  f"capture call {secs[0]:.4f} s, a replay of the phases' CUDA graphs {secs[1]:.4f} s, both == "
                  f"the warm-up's bytes; peak memory eager {eager_peak / 2**30:.3f} GiB, fused "
                  f"{fused_peak / 2**30:.3f} GiB (the capture call), proof {len(proof.to_bytes())} bytes, "
                  f"verified in {verify_s:.3f} s, top of stack == fib mod p")
        out[kind] = (launches, shapes)
        drain_program_checks()
    fused.release()
    return out


def preprocessed_phase(torch, dev: str) -> None:
    """Phase 5d: a statement whose AIR declares preprocessed columns
    (``bench_airs.square_lut_statement``) at MIDEN_PARAMS: at 2^PP_SMALL_LOG
    rows on the card and on the CPU, commitment and proof bytes equal; then
    one proof at 2^PP_FULL_LOG rows on the card. Each is verified against
    its preprocessed commitment."""
    from miden_tpu_torch.bench_airs import square_lut_statement
    from miden_tpu_torch.stark import MIDEN_PARAMS, build_preprocessed, prove, verify
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.transcript.challenger import DuplexChallenger

    for log_n, devices in ((PP_SMALL_LOG, (dev, "cpu")), (PP_FULL_LOG, (dev,))):
        st, tr = square_lut_statement(log_n, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp = build_preprocessed(st, MIDEN_PARAMS, device=dev)
        out = prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), preprocessed=pp, device=dev)
        torch.cuda.synchronize()
        made = [(proof_to_bytes(out.proof), pp.commitment(), time.perf_counter() - t0)]
        if "cpu" in devices:  # made in the CPU process
            (blob, root), secs = CPU_HALVES.get("preprocessed")
            made.append((blob, root, secs))
        if len({(blob, root) for blob, root, _ in made}) != 1:
            raise AssertionError(f"preprocessed statement 2^{log_n}: card and CPU proofs differ")
        digest = verify(MIDEN_PARAMS, st, out.proof, DuplexChallenger(SEED),
                        preprocessed_commitment=pp.commitment())
        if digest != out.digest:
            raise AssertionError(f"preprocessed statement 2^{log_n}: rejected")
        log(f"  preprocessed statement 2^{log_n} rows: " + ", ".join(
            f"{d} build_preprocessed + prove {secs:.3f} s" for d, (_, _, secs) in zip(devices, made))
            + f"; {len(made[0][0])} bytes" + (", card == CPU" if len(made) > 1 else "") + ", verified")
    log_phase(f"phase 5d preprocessed columns at MIDEN_PARAMS: card == CPU at 2^{PP_SMALL_LOG} rows, "
              f"2^{PP_FULL_LOG} rows proved on the card and verified")


def entry_phase(torch, kernels, dev: str, vm_launches: dict, vm_bytes: bytes, small_cpu_bytes: bytes) -> None:
    """Phase 9: the user entry surfaces on the card. ``vm_launches`` and
    ``vm_bytes``: the launches of a replayed prove_program of phase 5b (equal
    to its eager warm-up's) and its proof bytes; ``small_cpu_bytes``: phase 5a's CPU proof bytes."""
    import contextlib
    import gc
    import io

    from miden_tpu_torch import cli
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.stark import MIDEN_PARAMS
    from miden_tpu_torch.vm import assemble, execute
    from miden_tpu_torch.vm.mast_io import program_from_bytes, program_to_bytes
    from miden_tpu_torch.vm.package import MastPackage, assemble_program_package
    from miden_tpu_torch.vm.prove import prove_program
    from miden_tpu_torch.vm.resume import BreakReason, execute_stepwise

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "smoke_out", "entry")
    os.makedirs(work, exist_ok=True)
    src = fib_program(VM_FULL_REPS)
    masm = os.path.join(work, "vm_fib_18.masm")
    with open(masm, "w") as fh:
        fh.write(src)
    full = assemble(src)

    # -- (b) the wire forms (before (a): (a)'s in-process proof is vm-fib-18's
    # last before phase 8, which then only captures its phases) ----------
    small_src = fib_program(VM_SMALL_REPS)
    decoded = {
        "MAST wire form": program_from_bytes(program_to_bytes(assemble(small_src))),
        ".masp package": MastPackage.from_bytes(
            assemble_program_package("vm-fib-small", small_src).to_bytes()).program(),
    }
    for what, prog in decoded.items():
        _, proof = prove_program(prog, params=MIDEN_PARAMS, device=dev)
        if proof.to_bytes() != small_cpu_bytes:
            raise AssertionError(f"the program decoded from its {what} proves to other bytes")
    log_phase(f"phase 9b fib repeat.{VM_SMALL_REPS} through the MAST wire form and a .masp package: each "
              f"decoded program proved on the card == phase 5a's CPU bytes")

    # -- (a) the command line, in subprocesses ----------------------------
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))

    def run_cli(*calls) -> list:
        """Each call's (CompletedProcess, seconds), the calls run together."""
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "miden_tpu_torch", *args], cwd=root, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for args in calls]
        done = []
        try:
            for args, proc in zip(calls, procs):
                stdout, stderr = proc.communicate(timeout=600)
                done.append((subprocess.CompletedProcess(args, proc.returncode, stdout, stderr),
                             time.perf_counter() - t0))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return done

    def expect(proc, rc: int, what: str) -> list:
        if proc.returncode != rc:
            raise AssertionError(f"{what}: exit {proc.returncode}, expected {rc}\n{proc.stdout}\n{proc.stderr}")
        return proc.stdout.splitlines()

    mast, proof_path = os.path.join(work, "prog.mast"), os.path.join(work, "proof.bin")
    (out, compile_s), (ran, run_s) = run_cli(("compile", masm, "-o", mast), ("run", masm))
    printed_hash = expect(out, 0, "compile")[0]
    with open(mast, "rb") as fh:
        decoded = program_from_bytes(fh.read())
    if tuple(decoded.hash) != tuple(full.hash) or printed_hash != "program hash: " + " ".join(
            f"{v:016x}" for v in full.hash):
        raise AssertionError("compile -o: the written program does not decode to the program's digest")
    want_top = fib_top(VM_FULL_REPS, gl.P)
    if not expect(ran, 0, "run")[-1].startswith(f"output stack: [{want_top}, "):
        raise AssertionError(f"run printed {ran.stdout!r}")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    [(out, prove_s)] = run_cli(("prove", masm, "-o", proof_path))
    expect(out, 0, "prove")
    with open(proof_path, "rb") as fh:
        blob = fh.read()
    if blob != vm_bytes:
        raise AssertionError("the CLI's proof bytes differ from phase 5b's prove_program")
    flipped = bytearray(blob)
    flipped[8 + 32 + 32 + 16 * 8] ^= 1  # the low byte of the first stack output
    bad_path = os.path.join(work, "flipped.bin")
    with open(bad_path, "wb") as fh:
        fh.write(bytes(flipped))
    (out, verify_s), (bad, _) = run_cli(("verify", proof_path), ("verify", bad_path))
    expect(out, 0, "verify")
    if not expect(bad, 1, "verify of a flipped proof")[0].startswith("VERIFICATION FAILED"):
        raise AssertionError(f"verify of a flipped proof printed {bad.stdout!r}")
    log(f"  CLI subprocesses: compile -o {compile_s:.3f} s and run {run_s:.3f} s side by side, prove "
        f"{prove_s:.3f} s alone (interpreter start, kernel library load and prove_program on the card; this "
        f"process held {held / 2**30:.3f} GiB of the card), verify {verify_s:.3f} s beside the flipped "
        f"proof's; proof bytes == phase 5b's, verify exits 0, a flipped byte exits 1, the compiled program "
        f"decodes to the program's digest")
    # the CLI's prove in this process, its launches counted
    zero_counts(kernels)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["prove", masm, "-o", proof_path])
    torch.cuda.synchronize()
    inproc_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
    check_path(launches, "poseidon2", "the CLI's proof")
    with open(proof_path, "rb") as fh:
        if rc != 0 or fh.read() != vm_bytes:
            raise AssertionError("the CLI's in-process proof differs from phase 5b's")
    log(f"  launches of the CLI's prove (in this process, {inproc_s:.3f} s): {launches}; "
        f"{'equal to' if launches == vm_launches else 'NOT equal to'} phase 5b's")
    log_phase(f"phase 9a python -m miden_tpu_torch prove of VM fib repeat.{VM_FULL_REPS} on the card: "
              f"{prove_s:.3f} s in a subprocess, proof == phase 5b's bytes, verify accepts, flipped byte rejected")

    # -- (c) pause/resume ---------------------------------------------------
    t0 = time.perf_counter()
    want = execute(full)
    exec_s = time.perf_counter() - t0
    budget = 1 << 16
    t0 = time.perf_counter()
    ctx = execute_stepwise(full, cycles=budget)
    clks = []
    while not ctx.done:
        clks.append(ctx.clk)
        ctx.resume(budget)
    step_s = time.perf_counter() - t0
    if ctx.reason != BreakReason.FINISHED or ctx.output.stack != want.stack or ctx.output.clk != want.clk:
        raise AssertionError(f"stepwise execution ended {ctx.reason} at clk {ctx.clk}, not as execute()")
    log_phase(f"phase 9c pause/resume of VM fib repeat.{VM_FULL_REPS} by 2^16 cycles: {len(clks)} pauses "
              f"(clk {clks}), {step_s:.3f} s against {exec_s:.3f} s uninterrupted; stack and clk "
              f"{want.clk} equal")

    # -- (d) byte-hash commitments at a trace's size -----------------------
    drain_program_checks()
    byte_hash_phase(torch, dev)


def byte_hash_phase(torch, dev: str) -> None:
    """Phase 9d: the BLAKE3-256 and Keccak-256 LMCS configurations on
    random seeded matrices of vm-fib-18's LDE shapes, main (2^21, 51) and
    chiplets (2^16, 24) lifted together: card == CPU roots at (2^10, 51) and
    (2^6, 24), then at full size two synchronised commits, peak memory, 27
    queries opened and verified by the port's host verifier, and a tampered
    row rejected."""
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.field import goldilocks as F
    from miden_tpu_torch.merkle import lmcs as L
    from miden_tpu_torch.stark import MIDEN_PARAMS
    from miden_tpu_torch.transcript.challenger import DuplexChallenger, ProverChannel, VerifierChannel

    rng = np.random.default_rng(2026)
    small = [rng.integers(0, gl.P, size=s, dtype=np.uint64) for s in ((1 << 10, 51), (1 << 6, 24))]
    shapes = ((1 << 21, 51), (1 << 16, 24))
    big = [F.to_torch(rng.integers(0, gl.P, size=s, dtype=np.uint64), dev) for s in shapes]
    raw = [int(v) for v in rng.integers(0, shapes[0][0], size=MIDEN_PARAMS.num_queries)]
    for name in ("blake3_256", "keccak256"):
        cfg = L.HASH_CONFIGS[name]()
        roots = [L.build_tree([F.to_torch(m, d) for m in small], hash=cfg).root() for d in (dev, "cpu")]
        if (roots[0] != roots[1]).any():
            raise AssertionError(f"{name}: card and CPU roots differ at (2^10, 51) + (2^6, 24)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = L.build_tree(big, hash=cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        ch = ProverChannel(DuplexChallenger(SEED))
        flat, meta = L.gather_query_data(tree, torch.tensor(raw, dtype=torch.int64, device=dev))
        L.emit_opening_hints(ch, F.to_numpy(flat), meta, raw)
        _, data = ch.finalize()
        open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = L.verify_batch(tree.root(), [51, 24], shapes[0][0], raw,
                              VerifierChannel(data, DuplexChallenger(SEED)), hash=cfg)
        verify_s = time.perf_counter() - t0
        for d in set(raw):
            for m, (h, _), r in zip(big, shapes, rows[d]):
                if (F.to_numpy(m[d % h]) != r).any():
                    raise AssertionError(f"{name}: an opened row differs from the matrix")
        data.fields[0] = (data.fields[0] + 1) % gl.P
        try:
            L.verify_batch(tree.root(), [51, 24], shapes[0][0], raw,
                           VerifierChannel(data, DuplexChallenger(SEED)), hash=cfg)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name}: a tampered row verified")
        log_phase(f"phase 9d {name} LMCS over (2^21, 51) + (2^16, 24): card == CPU root at (2^10, 51) + "
                  f"(2^6, 24); commit {', '.join(f'{t:.4f}' for t in times)} s (synchronised), peak memory "
                  f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the matrices), "
                  f"{len(set(raw))} queries opened in {open_s:.3f} s and verified on the host in "
                  f"{verify_s:.3f} s, a tampered row rejected")
        del tree, flat  # so that the next hash's peak holds only its own tree


def vm_aux(trace, device: str) -> tuple:
    """The chiplets and Poseidon2 AIRs of a VM trace (``trace``: a dict of
    its statement's fields and those two matrices) build their LogUp aux
    traces on ``device`` from seeded randomness: [(AIR name, rows, aux,
    aux values, seconds)], tensors on ``device``."""
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.field import goldilocks as F
    from miden_tpu_torch.vm.prove import vm_statement

    statement = vm_statement(*(trace[k] for k in ("program_hash", "stack_inputs", "stack_outputs",
                                                  "kernel_digests", "deferred_root")))
    rng = np.random.default_rng(18)
    built = []
    for air, main in zip(statement.multi_air.airs[1:], (trace["chiplets"], trace["poseidon"])):
        rand = rng.integers(0, gl.P, size=(air.num_randomness, 2), dtype=np.uint64)
        t0 = time.perf_counter()
        aux, vals = air.build_aux_trace(F.to_torch(main, device), statement.publics, statement.aux_inputs,
                                        list(F.to_torch(rand, device)))
        built.append((type(air).__name__, main.shape[0], aux, vals, time.perf_counter() - t0))
    return built


def vm_aux_card_vs_cpu(dev: str) -> str:
    """stdlib-blake3-18's chiplets and Poseidon2 AIRs build their LogUp aux
    traces on the card and on the CPU from the same seeded randomness: the
    aux columns and aux values must be bit-equal. The CPU process's job
    "blake3_aux" executes the program and makes the CPU half; the card half
    runs on its trace."""
    from miden_tpu_torch.field import goldilocks as F

    (trace, want), _ = CPU_HALVES.get("blake3_aux")
    checked = []
    for (name, rows, aux, vals, card_s), (_, _, aux_c, vals_c, cpu_s) in zip(vm_aux(trace, dev), want):
        if not (np.array_equal(F.to_numpy(aux).reshape(-1), aux_c.reshape(-1))
                and np.array_equal(F.to_numpy(vals).reshape(-1), vals_c.reshape(-1))):
            raise AssertionError(f"{name}: the card's and the CPU's aux traces differ")
        checked.append(f"{name} ({rows} rows, aux {tuple(aux.shape)}; card {card_s:.3f} s, "
                       f"CPU {cpu_s:.3f} s in the CPU process)")
    return ", ".join(checked)


def stdlib_phase(torch, kernels, dev: str) -> tuple:
    """Phase 10: the MASM standard library on the card
    (``miden_tpu_torch.bench_stdlib``). (a) stdlib-small, the u64 program,
    at MIDEN_PARAMS on the card and on the CPU: bytes equal, the u64 on
    top; (b) stdlib-blake3-18, the reference's blake3_1to1 program (28
    hashes, 252,138 cycles): a traced warm-up and one timed prove_program
    call, the digest against the host chain, verified, and the chiplets and
    Poseidon2 AIRs' LogUp aux traces card == CPU; (c) stdlib-host, one
    program through mem, word, u128, sorted_array, mmr, smt, sha256,
    poseidon2 and an aead round trip, proved on the card, its outputs equal
    to the host's, verified; (d) MerkleTree over 2^16 seeded leaves on the
    card, every layer equal to the CPU's, with K3 compress_rows launches.
    Returns the launches and launch shapes of (b)'s first timed call."""
    from miden_tpu_torch import bench_stdlib as B
    from miden_tpu_torch.merkle import MerkleTree
    from miden_tpu_torch.stark import MIDEN_PARAMS
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.utils.tracing import Recorder
    from miden_tpu_torch.vm import native_trace
    from miden_tpu_torch.vm.prove import prove_program, verify_program

    handlers = stdlib_event_handlers()

    # -- (a) stdlib-small, card == CPU ---------------------------------------
    small = assemble_with_stdlib(B.U64_PROGRAM)
    out, on_card = prove_program(small, params=MIDEN_PARAMS, event_handlers=handlers, device=dev)
    drain_program_checks()
    cpu_bytes, cpu_s = CPU_HALVES.get("u64")
    if on_card.to_bytes() != cpu_bytes:
        raise AssertionError("stdlib-small: the card's and the CPU's proof bytes differ")
    if [int(v) for v in out.stack[:2]] != B.u64_program_top():
        raise AssertionError(f"stdlib-small left {out.stack[:2]}, the host's u64 is {B.u64_program_top()}")
    verify_program(on_card, params=MIDEN_PARAMS)
    log_phase(f"phase 10a stdlib-small (u64 program) MIDEN_PARAMS: card == CPU ({len(on_card.to_bytes())} bytes), "
              f"log heights {on_card.stark.log_heights}, u64 on top == host, verified; CPU prove {cpu_s:.3f} s "
              f"(in the CPU process)")

    # -- (b) stdlib-blake3-18 --------------------------------------------------
    prog, inputs = assemble_with_stdlib(B.blake3_chain_program(B.BLAKE3_REPS)), B.blake3_inputs()
    want = B.blake3_chain_digest(B.BLAKE3_REPS)
    # the warm-up is the traced call: spans synchronize at their edges
    t0 = time.perf_counter()
    with Recorder() as rec:
        prove_program(prog, inputs, params=MIDEN_PARAMS, event_handlers=handlers, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    drain_program_checks()
    # one timed call: with phase 11 a second one would crowd the 1200 s limit
    torch.cuda.reset_peak_memory_stats()
    shapes = {name: {} for name in kernels}
    zero_counts(kernels)
    native_trace.RUNS.update({k: 0 for k in native_trace.RUNS})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # fused=False: the second proof of this shape would pay the capture of
    # its phases, which the 1200 s limit cannot take for a one-shot timing
    b3_out, proof = prove_program(prog, inputs, params=MIDEN_PARAMS, event_handlers=handlers, device=dev,
                                  fused=False)
    torch.cuda.synchronize()
    b3_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
    record_shapes(kernels, shapes)
    runs = dict(native_trace.RUNS)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    verify_program(proof, params=MIDEN_PARAMS)
    verify_s = time.perf_counter() - t0
    if [int(v) for v in b3_out.stack[:8]] != want:
        raise AssertionError(f"stdlib-blake3-18 left {b3_out.stack[:8]}, {B.BLAKE3_REPS} host BLAKE3s give {want}")
    if b3_out.clk != B.BLAKE3_CYCLES or proof.stark.log_heights != B.BLAKE3_LOG_HEIGHTS:
        raise AssertionError(f"stdlib-blake3-18 ran {b3_out.clk} cycles, log heights {proof.stark.log_heights}")
    check_path(launches, "poseidon2", "stdlib-blake3-18")
    log(f"  card == CPU LogUp aux traces at full height: {vm_aux_card_vs_cpu(dev)}")
    trace_s = rec.totals["execute and trace"][0]
    log("  spans (traced warm-up prove_program, synchronized at span edges): " + "; ".join(
        f"{k} {v[0]:.4f} s" for k, v in rec.totals.items()))
    for span_name in ("evaluate constraints", "aux trace of one AIR"):
        log(f"  {span_name}, per AIR: " + ", ".join(
            f"{air} {v[0]:.4f} s" for (name, air), v in rec.by_air.items() if name == span_name))
    log(f"  launches per stdlib-blake3-18 proof: {launches}")
    log(f"  C trace generator: {runs['block']} blocks, {runs['rows']} of {b3_out.clk} cycles' core rows "
        f"({100 * runs['rows'] / b3_out.clk:.1f} %); the rest in the Python interpreter")
    log_phase(f"phase 10b stdlib-blake3-18 MIDEN_PARAMS: {b3_out.clk} cycles, log heights "
              f"{proof.stark.log_heights} (core, chiplets, poseidon); prove_program {b3_s:.4f} s (one timed call; "
              f"traced warm-up {warm_s:.3f} s), execute_and_trace "
              f"{trace_s:.4f} s (traced span; {100 * trace_s / b3_s:.1f} % of the timed call), peak memory "
              f"{peak / 2**30:.3f} GiB, proof {len(proof.to_bytes())} bytes, verified in {verify_s:.3f} s, "
              f"digest == {B.BLAKE3_REPS} host BLAKE3s")

    # -- (c) stdlib-host ---------------------------------------------------------
    src, advice, want = B.host_program()
    t0 = time.perf_counter()
    host_out, proof = prove_program(assemble_with_stdlib(src), advice=advice, params=MIDEN_PARAMS,
                                    event_handlers=handlers, device=dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    drain_program_checks()
    if [int(v) for v in host_out.stack[:16]] != want or list(proof.stack_outputs) != want:
        raise AssertionError("stdlib-host: the outputs differ from the host's sha256, poseidon2 and aead values")
    verify_program(proof, params=MIDEN_PARAMS)
    log_phase(f"phase 10c stdlib-host MIDEN_PARAMS: {host_out.clk} cycles, log heights {proof.stark.log_heights}, "
              f"proved on the card in {host_s:.3f} s; mem, word, u128, sorted_array, mmr, smt results asserted "
              f"in the VM, sha256 / poseidon2 / aead outputs == hashlib, poseidon2_host, AeadPoseidon2; verified")

    # -- (d) MerkleTree on the card ----------------------------------------------
    leaves = _merkle_leaves()
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = MerkleTree(leaves)
    card_s = time.perf_counter() - t0
    compress = {name: kern.launches for name, (kern, _, _) in kernels.items() if kern.launches}
    (cpu_root, cpu_nodes), cpu_s = CPU_HALVES.get("merkle")
    if list(tree.inner_nodes()) != cpu_nodes or tree.root != cpu_root:
        raise AssertionError("MerkleTree: the card's layers differ from the CPU's")
    if set(compress) != {"poseidon2_compress_rows"}:
        raise AssertionError(f"MerkleTree on the card launched {compress}, not K3 compress_rows alone")
    log_phase(f"phase 10d MerkleTree over 2^16 leaves: card {card_s:.3f} s ({compress}), CPU {cpu_s:.3f} s "
              f"(in the CPU process), root and every layer equal")
    return launches, shapes


def recursion_phase(torch, kernels, dev: str, fib_proof) -> tuple:
    """Phase 11: the in-VM STARK verifier (``miden_tpu_torch.bench_recursion``)
    on real proofs. (a) the recursion fixture of ``fib_proof``, phase 5b's
    vm-fib-18 proof at MIDEN_PARAMS: its statement rebuilt from the public
    claim, its transcript replayed from the protocol seed; (b) the transcript
    replay and the OOD identity programs executed in the VM: 1 on top, the
    replay's (z, α_deep, β_deep) equal to the fixture's, and a circuit blob
    with one bit flipped refused by load_circuit; (c) the replay program
    proved on the card at MIDEN_PARAMS under poseidon2 in one traced call (its
    launches, log heights, execute_and_trace span, the core rows the C trace
    generator wrote, peak memory, proof size) and verified; (d) at
    TEST_PARAMS, the fib repeat.40 program of tests/test_sysvm_masm.py
    proved on the card, both programs executed on its fixture, and
    fri_query_program proved on the card and on the CPU, bytes equal (the
    replay program's 2^17-row core is too large a CPU proof for the run).
    The OOD identity program (764k cycles, a 2^20-row core) is executed, not
    proved. Returns the launches and launch shapes of (c)."""
    from miden_tpu_torch import bench_recursion as R
    from miden_tpu_torch.stark import MIDEN_PARAMS, TEST_PARAMS
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.utils.tracing import Recorder
    from miden_tpu_torch.vm import assemble, native_trace
    from miden_tpu_torch.vm.processor import AdviceProvider, ExecutionError, execute
    from miden_tpu_torch.vm.prove import prove_program, protocol_seed, verify_program

    handlers = stdlib_event_handlers()

    def run(src, advice=()):
        return execute(assemble_with_stdlib(src), [], advice=AdviceProvider(stack=list(advice)),
                       event_handlers=handlers)

    def execute_both(statement, fx, params) -> str:
        """(b): the replay and the OOD identity executed, checked; a summary."""
        t0 = time.perf_counter()
        out = run(R.transcript_replay_program(fx, params, protocol_seed()), R.replay_advice(fx))
        replay_s = time.perf_counter() - t0
        want = [1, *fx.z, *fx.alpha_deep, *fx.beta_deep]
        if [int(v) for v in out.stack[:7]] != want:
            raise AssertionError(f"the in-VM replay left {out.stack[:7]}, the fixture gives {want}")
        t0 = time.perf_counter()
        src, adv = R.ood_identity_program(statement, fx, params)
        ood = run(src, adv)
        ood_s = time.perf_counter() - t0
        if int(ood.stack[0]) != 1:
            raise AssertionError(f"the in-VM OOD identity left {ood.stack[0]}")
        return (f"replay {out.clk} cycles in {replay_s:.3f} s, [1, z, alpha_deep, beta_deep] == the "
                f"fixture's; OOD identity {ood.clk} cycles in {ood_s:.3f} s, 1 on top")

    # -- (a) the fixture of vm-fib-18 ---------------------------------------------
    t0 = time.perf_counter()
    statement, fx = R.vm_recursion_fixture(fib_proof, MIDEN_PARAMS)
    fixture_s = time.perf_counter() - t0
    log(f"  fixture of vm-fib-18 (log heights {fx.log_heights}, log LDE {fx.log_lde_height}, "
        f"{len(fx.fri_betas)} FRI layers, {len(fx.indices)} distinct of {MIDEN_PARAMS.num_queries} queries) "
        f"in {fixture_s:.3f} s")

    # -- (b) both programs executed; a tampered circuit refused --------------------
    log(f"  executed at MIDEN_PARAMS: {execute_both(statement, fx, MIDEN_PARAMS)}")
    if int(run(R.LOAD_CIRCUIT_PROGRAM, R.load_circuit_advice()).stack[0]) != 100002:
        raise AssertionError("load_circuit did not authenticate the registry's circuit")
    try:
        run(R.LOAD_CIRCUIT_PROGRAM, R.load_circuit_advice(tamper=True))
    except ExecutionError:
        pass
    else:
        raise AssertionError("load_circuit accepted a circuit blob with one bit flipped")

    # -- (c) the replay program proved on the card in one traced call ---------------
    prog = assemble_with_stdlib(R.transcript_replay_program(fx, MIDEN_PARAMS, protocol_seed()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    native_trace.RUNS.update({k: 0 for k in native_trace.RUNS})
    t0 = time.perf_counter()
    with Recorder() as rec:
        out, proof = prove_program(prog, advice=AdviceProvider(stack=R.replay_advice(fx)), params=MIDEN_PARAMS,
                                   event_handlers=handlers, device=dev)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
    shapes = {name: {} for name in kernels}
    record_shapes(kernels, shapes)
    runs, peak = dict(native_trace.RUNS), torch.cuda.max_memory_allocated()
    drain_program_checks()
    check_path(launches, "poseidon2", "the replay program's proof")
    want = [1, *fx.z, *fx.alpha_deep, *fx.beta_deep]
    if [int(v) for v in out.stack[:7]] != want or list(proof.stack_outputs[:7]) != want:
        raise AssertionError("the proved replay program's outputs differ from the fixture's")
    t0 = time.perf_counter()
    verify_program(proof, params=MIDEN_PARAMS, partial=True)
    verify_s = time.perf_counter() - t0
    trace_s = rec.totals["execute and trace"][0]
    log("  spans (traced prove_program): " + "; ".join(f"{k} {v[0]:.4f} s" for k, v in rec.totals.items()))
    log(f"  launches per recursion-18 proof: {launches}")
    log_phase(f"phase 11a-c recursion-18: vm-fib-18's proof verified in the VM (replay and OOD identity; a "
              f"flipped circuit bit refused), and the replay program proved on the card at MIDEN_PARAMS: "
              f"{out.clk} cycles, log heights {proof.stark.log_heights} (core, chiplets, poseidon); "
              f"prove_program {prove_s:.3f} s (traced: spans synchronize at their edges), execute_and_trace "
              f"{trace_s:.3f} s ({100 * trace_s / prove_s:.1f} %), C trace generator {runs['rows']} of "
              f"{out.clk} core rows in {runs['block']} blocks ({100 * runs['rows'] / out.clk:.1f} %; the rest "
              f"in the Python interpreter), peak memory {peak / 2**30:.3f} GiB, proof {len(proof.to_bytes())} "
              f"bytes, verified in {verify_s:.3f} s")

    # -- (d) TEST_PARAMS: the fib repeat.40 proof, card == CPU ------------------------
    _, small_proof = prove_program(assemble(fib_program(40)), params=TEST_PARAMS, device=dev)
    small_st, small_fx = R.vm_recursion_fixture(small_proof, TEST_PARAMS)
    executed = execute_both(small_st, small_fx, TEST_PARAMS)
    fri = assemble_with_stdlib(R.fri_query_program(small_fx))
    _, on_card = prove_program(fri, params=TEST_PARAMS, event_handlers=handlers, device=dev)
    cpu_bytes, cpu_s = CPU_HALVES.get("fri_query")
    drain_program_checks()
    if on_card.to_bytes() != cpu_bytes:
        raise AssertionError("fri_query_program: the card's and the CPU's proof bytes differ")
    verify_program(on_card, params=TEST_PARAMS, partial=True)
    log_phase(f"phase 11d fib repeat.40 at TEST_PARAMS: {executed}; fri_query_program card == CPU "
              f"({len(on_card.to_bytes())} bytes, log heights {on_card.stark.log_heights}, CPU prove "
              f"{cpu_s:.3f} s in the CPU process), verified")
    return launches, shapes


#: the cell each kernel entry's JSON row reports: the VM proof under the
#: commitment hash whose trees the entry builds (K1, K2 and K3 under poseidon2)
ROW_KIND = {"rpo": "vm_rpo", "rpx": "vm_rpx"}


#: a sponge launch is held to its plain twin over every state where the twin
#: would take at most this many seconds, and above that over SAMPLE_STATES
#: states spread over the launch (Q1: points)
PLAIN_CHECK_S = 30.0
#: device seconds of Q1's plain twin an instruction-point beyond its launches
#: (an H100 80GB HBM3 at 700 W in this script's Q1 lines: the VM core's 2^21
#: points, 2 blocks, took 6.2 s at 9.5 us a launch)
TWIN_POINT_S = 5e-11
SAMPLE_STATES = 1 << 14
#: states of the batch that measures a plain permutation's seconds per state
PLAIN_RATE_STATES = 1 << 20


def dist_phase(torch, kernels, full, vm_bytes: bytes, vm_peak: int, eager_peak: int, small_bytes: bytes) -> tuple:
    """Phase 12: multi-device proving. (12a) ``full`` (5b's program) under an
    NCCL mesh of one rank, through the fused phases captured with their
    NCCL collectives (the eager warm-up, the capture call, a replay), each
    against 5b's bytes; (12d) ``prove_sharded`` of it on
    ``bench_dist.RANKS`` gloo ranks sharing the card, each rank's bytes
    against 5b's, its peak beside 5b's eager peak ``vm_peak`` and 5e's
    ``eager_peak``, the bytes it holds of the max-height tensors beside one
    device's, its traffic, its K1 / K2 / K3 / Q1 launches and Q1 held to its
    twin at its block and halo; (12c) fib ``repeat.10`` on 2 of those ranks
    against ``small_bytes`` (5a's CPU proof). Returns the launches and
    shapes of 12a's replay, 12d and 12c together, for phase 7."""
    from miden_tpu_torch import bench_dist

    kerns = {name: kern for name, (kern, _, _) in kernels.items()}
    t0 = time.perf_counter()
    a = bench_dist.nccl_prove(full, kerns)
    a_s = time.perf_counter() - t0
    for name, call in zip(("warm-up (eager)", "capture call", "replay"), a["calls"]):
        if call["bytes"] != vm_bytes:
            raise AssertionError(f"phase 12a: the {name} under the NCCL mesh differs from phase 5b's proof")
        check_path(call["launches"], "poseidon2", f"phase 12a {name}")
        log(f"  12a {name}: {call['seconds']:.4f} s, peak {call['peak'] / 2**30:.3f} GiB, bytes == phase 5b's; "
            f"launches {call['launches']}")
    replay = a["calls"][2]["launches"]
    if replay != a["calls"][0]["launches"]:
        raise AssertionError(f"phase 12a: the replay launched {replay}, the eager warm-up {a['calls'][0]['launches']}")
    log(f"  12a graphs (the port's kernel nodes read back from each phase's graph == the capture's launches; "
        f"the binding of the statement runs eagerly beside them): {a['graphs']}")
    log_phase(f"phase 12a vm-fib-18 under use_mesh(make_mesh('cuda')), {a['backend']} world size {a['world']}: "
              f"fused, the phases captured with their NCCL collectives; warm-up {a['calls'][0]['seconds']:.4f} s, "
              f"capture call {a['calls'][1]['seconds']:.4f} s, replay {a['calls'][2]['seconds']:.4f} s "
              f"({sum(replay.values())} launches == the warm-up's); all three == phase 5b's bytes "
              f"({len(vm_bytes)}); {a_s:.1f} s in all")
    drain_program_checks()  # Q1 at 12a's block and halo (the whole coset over one rank), then its LDEs go

    t0 = time.perf_counter()
    ranks = bench_dist.sharded_ranks(fib_program(VM_FULL_REPS), fib_program(VM_SMALL_REPS))
    spawn_s = time.perf_counter() - t0
    for k, r in enumerate(ranks):
        held = r["held"]
        launched = {name: r["launches"][name] for name in bench_dist.RANK_KERNELS}
        bad_q1 = {key: q for key, q in r["q1"].items() if q["err"]}
        if r["bytes"] != vm_bytes or held["not_sharded"] or held["local"] * bench_dist.RANKS != held["whole"]:
            raise AssertionError(f"phase 12d rank {k}: bytes {'==' if r['bytes'] == vm_bytes else '!='} 5b's, "
                                 f"not sharded {held['not_sharded']}, held {held}")
        if not all(launched.values()) or bad_q1 or not r["q1"]:
            raise AssertionError(f"phase 12d rank {k}: launches {launched}, Q1 checks {r['q1']}")
        if r["peak"] >= eager_peak:
            raise AssertionError(f"phase 12d rank {k}: peak {r['peak']} not below one device's {eager_peak}")
        b = r["commit"]
        if not (b["rows_equal"] and b["layers_equal"] and b["matrices_equal"]) or len(
                {tuple(x["commit"]["root"]) for x in ranks}) != 1:
            raise AssertionError(f"phase 12d rank {k}: the sharded commit of the main trace shapes differs from "
                                 f"one device's: {b}")
        log(f"  12d rank {k}: bytes == 5b's; {r['seconds']:.4f} s; peak {r['peak'] / 2**30:.3f} GiB (one "
            f"device eager: 5b {vm_peak / 2**30:.3f}, 5e {eager_peak / 2**30:.3f}); per phase (GiB) "
            + ", ".join(f"{ph} {v / 2**30:.3f}" for ph, v in r["phases"].items())
            + f"; max-height tensors held at the end of stage_open {held['local']} bytes, one device "
            f"{held['whole']} ({held['local'] / held['whole']:.4f}); traffic {r['traffic']}; launches {launched}; "
            + "; ".join(f"{Q1} at {key}: == twin over {q['points']} of {q['nd']} points, max |diff| "
                        f"{q['err']}, {q['ms']:.4f} ms" for key, q in r["q1"].items())
            + f"; the sharded commit of the main trace shapes: LDE rows {b['lde_rows']} and all {b['layers']} "
            f"layers == one device's, {b['seconds']:.4f} s (one device {b['single_seconds']:.4f} s), traffic "
            f"{b['traffic']}")
    for k, r in enumerate(ranks[:2]):
        c = r["small"]
        if c["bytes"] != small_bytes:
            raise AssertionError(f"phase 12c rank {k}: the proof differs from phase 5a's")
        # a proof this small has no transform above 2^12 rows: K2 is not on its path
        launched = {name for name, n in c["launches"].items() if n}
        if launched != set(path_kernels("poseidon2")) - {"ntt_transpose_twiddle"}:
            raise AssertionError(f"phase 12c rank {k}: launches {c['launches']}")
    log_phase(f"phase 12d prove_sharded of vm-fib-18 on {bench_dist.RANKS} gloo ranks sharing the card: every "
              f"rank's bytes == phase 5b's; seconds {', '.join('%.4f' % r['seconds'] for r in ranks)}; peaks "
              f"{', '.join('%.3f' % (r['peak'] / 2**30) for r in ranks)} GiB (one device eager {eager_peak / 2**30:.3f}); "
              f"each rank holds 1/{bench_dist.RANKS} of the max-height tensors; 12c fib repeat.{VM_SMALL_REPS} on "
              f"2 of them == phase 5a's bytes; the ranks' whole run {spawn_s:.3f} s")

    for key, q in (item for r in ranks for item in r["q1"].items()):
        PROGRAM_CHECKS.held.setdefault(key, {"err": q["err"], "points": q["points"], "nd": q["nd"], "ms": q["ms"]})
    drain_program_checks()
    launches = {name: 0 for name in kernels}
    shapes = {name: {} for name in kernels}
    for part in [a["calls"][2], *ranks, *(r["commit"] for r in ranks), *(r["small"] for r in ranks[:2])]:
        for name in kernels:
            launches[name] += part["launches"][name]
            for key, count in part["shapes"][name].items():
                shapes[name][key] = shapes[name].get(key, 0) + count
    return launches, shapes


def q1_phase2_airs() -> list:
    """(AIR, LDE row stride) of phase 2's Q1 checks on row-strided views
    (the proofs' VM quotients read stride-1 LDEs at MIDEN_PARAMS): two VM
    AIRs (Poseidon2's with 16 periodic columns) and an AIR with
    preprocessed columns. The core is held at every proof shape."""
    from miden_tpu_torch.bench_airs import SquareLutAir
    from miden_tpu_torch.vm.constraints.chiplets_air import ChipletsVmAir
    from miden_tpu_torch.vm.constraints.poseidon2_air import Poseidon2PermutationAir

    return [(ChipletsVmAir(), 2), (Poseidon2PermutationAir(), 2), (SquareLutAir(12), 4)]


def q1_random_check(torch, rand, air, stride: int, halo: bool = False) -> tuple:
    """Q1 against its twin on random card inputs over 2^12 points (next rows
    8 ahead, wrapping at the end; with ``halo``, the last 8 points' next
    rows read from a separate 8-point halo, as on a rank's block), the LDE
    sources row-strided views. Returns (max |diff|, points)."""
    from miden_tpu_torch.stark import interp

    nd = 1 << 12

    def view(k, n=nd):
        return rand((n * stride, k))[::stride] if k else None

    halos = (view(air.width, 8), view(air.preprocessed_width, 8), view(2 * air.aux_width, 8)) if halo else None
    prog, inp = interp.program_inputs(
        air, view(air.width), view(2 * air.aux_width), tuple(rand((nd,)) for _ in range(3)),
        rand((max(40, air.num_public_values),)), rand((air.num_randomness, 2)), rand((air.num_aux_values, 2)),
        [rand((nd,)) for _ in air.periodic_columns], rand((2,)), view(air.preprocessed_width), 8, halo=halos,
    )
    return max_abs_err(interp.run_program_kernel(prog, inp), interp.run_program_plain(prog, inp)), nd


class ProgramChecks:
    """Holds Q1 to its plain twin at every (AIR, points) shape the script's
    proofs launch it with, on the proofs' own inputs. While installed it
    watches ``stark.prover.evaluate_quotient``: the first call on the card at
    a new shape keeps its arguments (the AIR's LDEs and challenges, which the
    proof holds to its end anyway), and :meth:`drain`, called after the
    run's numbers are read, checks each kept shape and lets its arguments go:
    Q1 against the twin over every point where the twin would take at most
    PLAIN_CHECK_S (:meth:`plain_estimate_s`), else over
    :func:`spread_states`' SAMPLE_STATES points
    (their last quarter takes the last D points, whose next rows wrap
    around); Q1's ms there (CUDA events) and its bound. With ``eager`` set
    at a shape's first call, the quotient through Q1 is also held to the
    eager evaluator's over the whole domain."""

    def __init__(self, torch, launch_us: float):
        self.torch = torch
        self.launch_s = launch_us * 1e-6  # the host's cost of one launch
        self.pending: list = []
        self.held: dict = {}  # (AIR, points) -> what the check found
        self.eager = False

    def plain_estimate_s(self, prog, nd: int) -> float:
        """Seconds the plain twin takes over all nd points: some 25 launches
        an instruction over each block (launch-bound up to a block's 2^20
        points), plus TWIN_POINT_S an instruction-point for the device's
        work."""
        from miden_tpu_torch.stark import interp

        blocks = nd // interp.plain_block_points(prog, nd)
        return prog.n_instr * (blocks * 25 * self.launch_s + nd * TWIN_POINT_S)

    def install(self) -> None:
        from miden_tpu_torch.bench_dist import q1_key
        from miden_tpu_torch.dist.mesh import RowShard
        from miden_tpu_torch.stark import prover
        from miden_tpu_torch.utils import cuda

        real = prover.evaluate_quotient

        def watched(air, domain, main_lde, aux_lde, log_d, *rest):
            # eager runs only: a capture runs nothing, and its tensors live in the graphs' pool
            on_card = (main_lde.local if isinstance(main_lde, RowShard) else main_lde).is_cuda
            if on_card and not cuda.capturing() and prover.uses_program(air, domain.trace_height, log_d):
                key = q1_key(air, domain, main_lde, log_d, rest[5] if len(rest) > 5 else None)
                if key not in self.held and all(k != key for k, _, _ in self.pending):
                    self.pending.append((key, (air, domain, main_lde, aux_lde, log_d, *rest), self.eager))
            return real(air, domain, main_lde, aux_lde, log_d, *rest)

        prover.evaluate_quotient = watched

    def drain(self) -> None:
        from miden_tpu_torch.bench_kernels import int32_mul_rate, time_ms
        from miden_tpu_torch.bench_quotient import bound_ms
        from miden_tpu_torch.stark import interp, prover

        torch = self.torch
        mul_rate = int32_mul_rate()
        pending, self.pending = self.pending, []
        for key, args, eager in pending:
            t0 = time.perf_counter()
            prog, inp, _ = prover.quotient_program_inputs(*args)
            nd = inp.nd
            got = interp.run_program_kernel(prog, inp)
            est_s = self.plain_estimate_s(prog, nd)
            if est_s <= PLAIN_CHECK_S:
                out = []
                plain_ms = time_ms(lambda: out.append(interp.run_program_plain(prog, inp)), 1, warm=False)
                err, points = max_abs_err(got, out[0]), nd
                del out
            else:
                idx = spread_states(torch, nd)
                err, points = max_abs_err(got[idx], interp.run_program_plain(prog, inp, idx)), len(idx)
                plain_ms = None
            ms = time_ms(lambda: interp.run_program_kernel(prog, inp), 3)
            b_ms, b_by = bound_ms(prog, inp, mul_rate)
            eager_equal = None
            if eager:
                eager_equal = torch.equal(prover.evaluate_quotient_program(*args),
                                          prover.evaluate_quotient_eager(*args))
            launch = interp.q1_plan(prog, nd).describe()
            self.held[key] = {"err": err, "points": points, "nd": nd, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "eager_equal": eager_equal,
                              "instructions": prog.n_instr, "frame": prog.frame_size,
                              "scheduled_frame": prog.schedule(interp.Q1_DEFAULT.on_chip).frame_size,
                              "launch": launch}
            del got, prog, inp, args
            torch.cuda.empty_cache()
            log(f"  {Q1} at {key}: == plain twin over {points} of {nd} points, max |diff| {err}"
                + ("" if eager_equal is None else
                   f"; the quotient through Q1 {'==' if eager_equal else '!='} the eager evaluator's "
                   f"over all {nd} points")
                + f"; {ms:.4f} ms/launch (plain {'%.1f' % plain_ms if plain_ms is not None else 'not timed'}"
                f" ms, estimated {1e3 * est_s:.1f}; bound {b_ms:.4f} ms by {b_by}); frame "
                f"{self.held[key]['frame']} slots recorded, {self.held[key]['scheduled_frame']} scheduled; "
                f"launch {launch} "
                f"({time.perf_counter() - t0:.1f} s)")
            if err or eager_equal is False:
                raise AssertionError(f"{Q1} at {key}: disagrees with its plain twin or the eager evaluator")

    def row(self, proofs) -> dict:
        """Q1's JSON row: its largest shape on the VM proof, and its launches
        and ms per proof of each kind (Σ launches × ms over its shapes)."""
        missing = sorted({k for _, shapes in proofs.values() for k in shapes[Q1]} - set(self.held))
        if missing:
            raise AssertionError(f"{Q1} launched at shapes never held to its twin: {missing}")
        vm_keys = proofs["vm"][1][Q1]
        key = max(vm_keys, key=lambda k: self.held[k]["nd"] * self.held[k]["instructions"])
        rec = self.held[key]
        per_proof = {kind: sum(c * self.held[k]["ms"] for k, c in shapes[Q1].items())
                     for kind, (_, shapes) in proofs.items()}
        log(f"  {Q1}: kernel == plain at all {len(self.held)} shapes ("
            + ", ".join(f"{k[0]} {k[1]}: {r['points']} points" for k, r in sorted(self.held.items()))
            + f"), max |diff| {max(r['err'] for r in self.held.values())}; per proof: " + "; ".join(
                f"{kind} {proofs[kind][0][Q1]} launches over {len(proofs[kind][1][Q1])} shapes, "
                f"{per_proof[kind]:.3f} ms" for kind in proofs))
        return {
            "name": Q1, "route": "cuda", "source": "miden_tpu_torch/csrc/constraints.cu",
            "replaces": "miden_tpu/stark/interp.py:273", "launches": proofs["vm"][0][Q1],
            "max_abs_err": max(r["err"] for r in self.held.values()), "ms": round(rec["ms"], 6),
            "plain_ms": round(rec["plain_ms"], 6), "bound_ms": round(rec["bound_ms"], 6),
            "bound_by": rec["bound_by"], "library_ms": None, "cell": "vm", "shape": list(key),
            "launch": rec["launch"], "frame": rec["frame"], "scheduled_frame": rec["scheduled_frame"],
            "launches_at_shape": vm_keys[key],
            "per_proof": {kind: {"launches": proofs[kind][0][Q1], "ms": round(per_proof[kind], 6)}
                          for kind in proofs},
        }


#: the Q1 checks of the run (installed in main after the build)
PROGRAM_CHECKS = None


def drain_program_checks() -> None:
    if PROGRAM_CHECKS is not None:
        PROGRAM_CHECKS.drain()


def spread_states(torch, n: int):
    """Indices of SAMPLE_STATES of a launch's n states: the first and the
    last quarter of them, and half at an even stride over the launch (every
    state where n is no larger)."""
    if n <= SAMPLE_STATES:
        return torch.arange(n, device="cuda")
    q = SAMPLE_STATES // 4
    stride = n // (2 * q)
    return torch.cat([
        torch.arange(q), torch.arange(n - q, n), torch.arange(2 * q) * stride + stride // 2,
    ]).cuda()


def hold_sponge_launch(torch, bench: dict, s_per_perm: float) -> tuple:
    """Holds one launch of a sponge entry (a :func:`bench_case`) against its
    plain twin: over every state where ``s_per_perm`` (the twin's seconds per
    permutation at PLAIN_RATE_STATES states) x the launch's permutations,
    with smaller launches costed as that many states, is at most
    PLAIN_CHECK_S; else over :func:`spread_states` (each state is independent
    of the others, so the check is exact for those). Returns (max |diff|,
    states compared, the twin's ms over every state or None)."""
    from miden_tpu_torch.bench_kernels import time_ms

    n = bench["states"]
    est_s = s_per_perm * bench["perms"] * max(1, PLAIN_RATE_STATES / n)
    if est_s > PLAIN_CHECK_S:
        idx = spread_states(torch, n)
        return max_abs_err(*bench["at"](idx)), len(idx), None
    got, out = bench["kernel"](), []
    plain_ms = time_ms(lambda: out.append(bench["plain"]()), 1, warm=False)
    return max_abs_err(got, out[0]), n, plain_ms


def kernel_rows(torch, kernels, proofs, errs, rand) -> list:
    """Holds each kernel against its plain twin on random inputs at every
    shape the proofs launched it with (the shaped proof's traces are zeros,
    so its launches alone would not show the kernels right there), times
    it there, and returns one JSON row per entry launched on a VM proof: its
    largest shape on the VM proof of its cell with bound and plain time, and
    its launches and ms per proof of each kind. A sponge entry is held to
    its twin over every state of a launch unless the twin would take more
    than PLAIN_CHECK_S there (:func:`hold_sponge_launch`). ``proofs``:
    kind -> (launches, shapes) for "vm", "shaped", "session", "vm_rpo",
    "vm_rpx", "blake3" (stdlib-blake3-18), "recursion" (recursion-18) and
    "dist" (phase 12's runs together)."""
    from miden_tpu_torch.bench_kernels import (
        HBM_BYTES_PER_S, INT32_MULS_PER_PERM, bench_case, bound_ms, int32_mul_rate, time_ms,
    )
    from miden_tpu_torch.hash import poseidon2, rescue
    from miden_tpu_torch.ntt import ntt

    sponge_map = {"poseidon2": poseidon2, "rpo": rescue.RPO, "rpx": rescue.RPX}
    s_per_perm = {}
    for perm, sp in sponge_map.items():
        s = rand((12, PLAIN_RATE_STATES))
        s_per_perm[perm] = time_ms(lambda: sp.permute_plain(s), 1, warm=False) / 1e3 / PLAIN_RATE_STATES
    log("  plain twins' s per permutation at 2^20 states: " + ", ".join(
        f"{perm} {v:.4g}" for perm, v in s_per_perm.items()))
    mul_rate = int32_mul_rate()
    rows = []
    for name, (kern, source, replaces) in kernels.items():
        if name == Q1:  # held on the proofs' own inputs (ProgramChecks)
            row = PROGRAM_CHECKS.row(proofs)
            errs[name] = row["max_abs_err"] = max(row["max_abs_err"], errs[name])
            rows.append(row)
            continue
        entry_t0 = time.perf_counter()
        perm = name.split("_")[0]
        main = ROW_KIND.get(perm, "vm")
        per_proof = {kind: 0.0 for kind in proofs}
        keys = sorted(set().union(*(shapes[name] for _, shapes in proofs.values())))
        if not keys:  # an entry no proof launches (R1 / R2 permute): one shape
            keys = [(1 << 16,)]
        top, sampled = None, []
        for key in keys:
            bench = bench_case(ntt, sponge_map, rand, name, key)
            plain_ms = None
            if perm in INT32_MULS_PER_PERM:
                err, covered, plain_ms = hold_sponge_launch(torch, bench, s_per_perm[perm])
                if covered < bench["states"]:
                    sampled.append(key)
            else:
                err = max_abs_err(*bench["check"]())
            errs[name] = max(errs[name], err)
            ms = time_ms(bench["kernel"], bench["reps"])
            counts = {kind: shapes[name].get(key, 0) for kind, (_, shapes) in proofs.items()}
            for kind, count in counts.items():
                per_proof[kind] += ms * count
            if name == "ntt_col_transform":
                k_bound = bound_ms(bench, mul_rate)
                log(f"    {name} at {key}: {ms:.4f} ms/launch x " + " / ".join(
                    f"{c} ({kind})" for kind, c in counts.items()
                ) + f", bound {k_bound:.4f} ms ({100 * k_bound / ms:.1f} % of bound)")
            # the row reports the largest shape of its cell's VM proof
            on_main = counts[main] > 0 or not proofs[main][0][name]
            if on_main and (top is None or bench["elems"] > top[1]["elems"]):
                top = (key, bench, ms, counts[main], plain_ms)
        over = (f" (over every state at {len(keys) - len(sampled)}; at {sampled}, where the plain "
                f"twin would take over {PLAIN_CHECK_S:g} s, over {SAMPLE_STATES} states: the first "
                f"and last {SAMPLE_STATES // 4} and {SAMPLE_STATES // 2} at an even stride)"
                if sampled else "")
        log(f"  {name}: kernel == plain at all {len(keys)} shapes{over}, max |diff| {errs[name]} "
            f"({time.perf_counter() - entry_t0:.1f} s)")
        if errs[name]:
            raise AssertionError(f"{name} disagrees with its plain version at the proofs' shapes")
        key, bench, ms, count, plain_ms = top
        if plain_ms is None:
            plain_ms = time_ms(bench["plain"], 1, warm=False)
        b_ms = bound_ms(bench, mul_rate)
        bound_by = ("bytes" if bench["bytes"] / HBM_BYTES_PER_S >= bench["ops"] / mul_rate
                    else "operations")
        log(f"  {name} at {key}: {ms:.4f} ms/launch (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {bound_by}); per proof: " + "; ".join(
                f"{kind} {proofs[kind][0][name]} launches over {len(proofs[kind][1][name])} shapes, "
                f"{per_proof[kind]:.3f} ms" for kind in proofs))
        if not proofs[main][0][name]:
            continue  # not on a proof's path: no JSON row
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": proofs[main][0][name], "max_abs_err": errs[name],
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6), "bound_ms": round(b_ms, 6),
            "bound_by": bound_by, "library_ms": None, "cell": main, "shape": list(key),
            "launches_at_shape": count,
            "per_proof": {kind: {"launches": proofs[kind][0][name], "ms": round(per_proof[kind], 6)}
                          for kind in proofs},
        }
        if "copy" in bench:  # the bare transpose copy, a yardstick for K2
            row["copy_ms"] = round(time_ms(bench["copy"], bench["reps"]), 6)
        rows.append(row)
    return rows


#: torch threads of the process that makes the CPU halves of the card ==
#: CPU checks (CpuHalves): it runs beside the card's process and leaves it
#: the host's other cores for its launches
CPU_THREADS = 4


def _merkle_leaves() -> list:
    return [tuple(int(v) for v in row) for row in
            np.random.default_rng(10).integers(0, 2**63, size=(1 << 16, 4), dtype=np.uint64)]


def _cpu_shaped() -> bytes:
    from miden_tpu_torch.bench_airs import miden_shaped_statement
    from miden_tpu_torch.stark import MIDEN_PARAMS, prove
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.transcript.challenger import DuplexChallenger

    st, tr = miden_shaped_statement(SMALL_LOG, device="cpu")
    return proof_to_bytes(prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device="cpu").proof)


def _cpu_vm_fib(hash_name: str) -> bytes:
    from miden_tpu_torch.stark import MIDEN_PARAMS
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import prove_program

    params = dataclasses.replace(MIDEN_PARAMS, hash_name=hash_name)
    return prove_program(assemble(fib_program(VM_SMALL_REPS)), params=params, device="cpu")[1].to_bytes()


def _cpu_preprocessed() -> tuple:
    from miden_tpu_torch.bench_airs import square_lut_statement
    from miden_tpu_torch.stark import MIDEN_PARAMS, build_preprocessed, prove
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.transcript.challenger import DuplexChallenger

    st, tr = square_lut_statement(PP_SMALL_LOG, device="cpu")
    pp = build_preprocessed(st, MIDEN_PARAMS, device="cpu")
    out = prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), preprocessed=pp, device="cpu")
    return proof_to_bytes(out.proof), pp.commitment()


def _cpu_u64() -> bytes:
    from miden_tpu_torch import bench_stdlib as B
    from miden_tpu_torch.stark import MIDEN_PARAMS
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.vm.prove import prove_program

    return prove_program(assemble_with_stdlib(B.U64_PROGRAM), params=MIDEN_PARAMS,
                         event_handlers=stdlib_event_handlers(), device="cpu")[1].to_bytes()


def _cpu_merkle() -> tuple:
    from miden_tpu_torch.merkle.tree import MerkleTree

    tree = MerkleTree(_merkle_leaves(), device="cpu")
    return tree.root, list(tree.inner_nodes())


def _cpu_session_airs() -> list:
    from miden_tpu_torch.field import goldilocks as F

    return [(name, log_n, [F.to_numpy(t) for t in outs]) for name, log_n, outs in session_air_outputs("cpu")]


def _cpu_blake3_aux() -> tuple:
    """stdlib-blake3-18's trace (its statement's fields, the chiplets and
    Poseidon2 matrices) and their aux traces on the CPU."""
    from miden_tpu_torch import bench_stdlib as B
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.vm.trace import execute_and_trace

    prog = assemble_with_stdlib(B.blake3_chain_program(B.BLAKE3_REPS))
    _, tr = execute_and_trace(prog, B.blake3_inputs(), event_handlers=stdlib_event_handlers())
    from miden_tpu_torch.field import goldilocks as F

    trace = {k: getattr(tr, k) for k in ("program_hash", "stack_inputs", "stack_outputs", "kernel_digests",
                                         "deferred_root", "chiplets", "poseidon")}
    return trace, [(name, rows, F.to_numpy(aux), F.to_numpy(vals), secs)
                   for name, rows, aux, vals, secs in vm_aux(trace, "cpu")]


def _cpu_fri_query() -> bytes:
    """fri_query_program made from the CPU's own fib repeat.40 proof at
    TEST_PARAMS, proved on the CPU."""
    from miden_tpu_torch import bench_recursion as R
    from miden_tpu_torch.stark import TEST_PARAMS
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import prove_program

    _, small_proof = prove_program(assemble(fib_program(40)), params=TEST_PARAMS, device="cpu")
    _, fx = R.vm_recursion_fixture(small_proof, TEST_PARAMS)
    fri = assemble_with_stdlib(R.fri_query_program(fx))
    return prove_program(fri, params=TEST_PARAMS, event_handlers=stdlib_event_handlers(), device="cpu")[1].to_bytes()


#: the CPU halves, in the order the phases need them: job -> (function, arguments)
CPU_JOBS = {
    "shaped": (_cpu_shaped, ()),  # phase 3
    "vm_fib": (_cpu_vm_fib, ("poseidon2",)),  # phase 5a (and 9b, 12c)
    "vm_fib_rpo256": (_cpu_vm_fib, ("rpo256",)),  # phase 5c
    "vm_fib_rpx256": (_cpu_vm_fib, ("rpx256",)),
    "preprocessed": (_cpu_preprocessed, ()),  # phase 5d
    "session_airs": (_cpu_session_airs, ()),  # phase 6a
    "u64": (_cpu_u64, ()),  # phase 10a
    "blake3_aux": (_cpu_blake3_aux, ()),  # phase 10b
    "merkle": (_cpu_merkle, ()),  # phase 10d
    "fri_query": (_cpu_fri_query, ()),  # phase 11d
}


def cpu_job(job: str) -> tuple:
    """One CPU half, run in the CPU process: (its result, seconds)."""
    import torch

    torch.set_num_threads(CPU_THREADS)
    fn, args = CPU_JOBS[job]
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


class CpuHalves:
    """The CPU halves of the card == CPU checks, made in one spawned process
    (CPU_THREADS torch threads) while the card works: every job of CPU_JOBS
    is queued at the start; :meth:`get` waits for one."""

    def __init__(self):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.jobs = {job: self.pool.apply_async(cpu_job, (job,)) for job in CPU_JOBS}

    def get(self, job: str) -> tuple:
        """(result, seconds it took in the CPU process)."""
        return self.jobs[job].get()

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


#: the CPU process of the run (started in main after the build)
CPU_HALVES = None


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from miden_tpu_torch import native
    from miden_tpu_torch.utils import cuda

    card = nvidia_smi("name,power.limit")
    kernels = kernel_table()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; host "
        f"{os.cpu_count()} CPUs, load average {os.getloadavg()[0]:.2f}")

    # -- 1. build ------------------------------------------------------------
    secs = cuda.build_all()
    for name in ("ntt", "poseidon2", "rescue", "constraints"):
        ptxas = [
            ln.strip() for ln in (cuda.BUILD_DIR / f"{name}.log").read_text().splitlines()
            if "registers" in ln or "spill" in ln
        ]
        log(f"  ptxas {name}: " + " | ".join(ptxas))
    t0 = time.perf_counter()
    native.trace_gen_lib()
    log_phase(f"phase 1 build: {secs:.3f} s for csrc/ntt.cu, csrc/poseidon2.cu, csrc/rescue.cu and "
              f"csrc/constraints.cu, "
        f"{time.perf_counter() - t0:.3f} s for native/trace_gen.c ({native.LIBRARY.name})")

    global CPU_HALVES
    CPU_HALVES = CpuHalves()
    try:
        return card_phases(torch, kernels, card)
    finally:
        CPU_HALVES.close()


def card_phases(torch, kernels, card: str) -> int:
    """Phases 2-12 and the result lines, with the CPU process running."""
    from miden_tpu_torch.bench_airs import miden_shaped_statement
    from miden_tpu_torch.bench_session import _launch_us
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.hash import poseidon2, rescue, rescue_host
    from miden_tpu_torch.ntt import ntt
    from miden_tpu_torch.stark import MIDEN_PARAMS, fused, prove, verify
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.transcript.challenger import DuplexChallenger
    from miden_tpu_torch.utils.tracing import Recorder
    from miden_tpu_torch.vm import assemble, native_trace
    from miden_tpu_torch.vm.prove import prove_program, verify_program
    from miden_tpu_torch.vm.trace import execute_and_trace

    log(f"  host launch cost: {_launch_us(torch):.2f} us a one-element add")
    global PROGRAM_CHECKS
    PROGRAM_CHECKS = ProgramChecks(torch, _launch_us(torch))
    PROGRAM_CHECKS.install()

    # -- 2. kernels against their plain twins -------------------------------
    dev = "cuda"
    card_gen = torch.Generator(device=dev)
    card_gen.manual_seed(2024)

    def rand(shape):
        """Uniform canonical field elements made on the card from a seeded
        generator: phase 7's inputs reach 2^28 elements, which the host's
        generator takes seconds each to make and copy. Values >= p (as u64,
        v in (-2^32, 0) as int64) wrap to v - p = v + 2^32 - 1."""
        halves = torch.randint(0, 1 << 32, (2, *shape), generator=card_gen, dtype=torch.int64, device=dev)
        v = (halves[0] << 32) | halves[1]
        return torch.where((v < 0) & (v > -(1 << 32)), v + ((1 << 32) - 1), v)

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
    for perm, sponge in (("rpo", rescue.RPO), ("rpx", rescue.RPX)):
        for n in (1, 999, 1 << 14):
            s = rand((12, n))
            err = max_abs_err(sponge.permute_kernel(s), sponge.permute_plain(s))
            errs[f"{perm}_permute"] = max(errs[f"{perm}_permute"], err)
            checked[f"{perm}_permute"] += 1
        for max_h, h, w in ((1, 1, 3), (256, 64, 51), (1 << 12, 1 << 10, 22), (1 << 12, 1 << 12, 8)):
            s, m = rand((12, max_h)), rand((h, w))
            err = max_abs_err(sponge.absorb_rows_kernel(s, m), sponge.absorb_rows_plain(s, m))
            errs[f"{perm}_absorb_rows"] = max(errs[f"{perm}_absorb_rows"], err)
            checked[f"{perm}_absorb_rows"] += 1
        for m in (1, 999, 1 << 14):
            cur = rand((2 * m, 4))
            err = max_abs_err(sponge.compress_rows_kernel(cur), sponge.compress_rows_plain(cur))
            errs[f"{perm}_compress_rows"] = max(errs[f"{perm}_compress_rows"], err)
            checked[f"{perm}_compress_rows"] += 1
        # edge states (0, 1, p - 1, p - 2, 2^32 - 1, 2^32, 2^48, 2^63 - 1, 2^63, all-equal and
        # mixed lanes): the carry paths of the squares and lazy sums, against the twin and rescue_host
        host = rescue_host.rpo_permute if perm == "rpo" else rescue_host.rpx_permute
        for entry, err in rescue.hold_edge_states(sponge, host, dev).items():
            errs[f"{perm}_{entry}"] = max(errs[f"{perm}_{entry}"], err)
            checked[f"{perm}_{entry}"] += 1
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
    for air, stride in q1_phase2_airs():
        for halo in (False, True):
            err, checked_points = q1_random_check(torch, rand, air, stride, halo)
            errs[Q1] = max(errs[Q1], err)
            checked[Q1] += 1
    torch.cuda.synchronize()
    for name, (kern, _, _) in kernels.items():
        log(f"  {name}: {checked[name]} comparisons, {kern.launches} launches, max |diff| {errs[name]}")
    if any(errs.values()):
        raise AssertionError(f"kernel disagrees with its plain version: {errs}")
    log_phase("phase 2 kernels vs plain: all equal (tolerance 0: Goldilocks arithmetic is exact)")

    # -- 3. small proof, card vs CPU ----------------------------------------
    st, tr = miden_shaped_statement(SMALL_LOG, device=dev)
    out_gpu = prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev)
    b_cpu, cpu_s = CPU_HALVES.get("shaped")
    b_gpu = proof_to_bytes(out_gpu.proof)
    if b_gpu != b_cpu:
        raise AssertionError("card and CPU proofs differ")
    if verify(MIDEN_PARAMS, st, out_gpu.proof, DuplexChallenger(SEED)) != out_gpu.digest:
        raise AssertionError("verifier digest differs from the prover's")
    log_phase(f"phase 3 small proof 2^{SMALL_LOG} MIDEN_PARAMS: card == CPU ({len(b_gpu)} bytes), "
        f"verified; CPU prove {cpu_s:.3f} s (in the CPU process)")

    # -- 4. full-size proof -------------------------------------------------
    shapes = {name: {} for name in kernels}  # shaped-18 proof: shape -> launches
    vm_shapes = {name: {} for name in kernels}  # VM proof (phase 5b)

    # eager (fused=False), as before the fused path: its timings and spans stay
    # comparable, and its shape's capture would crowd the 1200 s limit
    st, tr = miden_shaped_statement(FULL_LOG, device=dev)
    t0 = time.perf_counter()
    prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev, fused=False)
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
    out = prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev, fused=False)
    stop.record()
    torch.cuda.synchronize()
    prove_s = start.elapsed_time(stop) / 1e3
    launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
    record_shapes(kernels, shapes)
    peak = torch.cuda.max_memory_allocated()
    with Recorder() as rec:
        prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev, fused=False)
    t0 = time.perf_counter()
    digest = verify(MIDEN_PARAMS, st, out.proof, DuplexChallenger(SEED))
    verify_s = time.perf_counter() - t0
    if digest != out.digest:
        raise AssertionError("full-size proof rejected")
    check_path(launches, "poseidon2", "the shaped proof", program=False)
    log("  spans (traced prove, synchronized at span edges): " + "; ".join(
        f"{k} {v[0]:.4f} s" for k, v in rec.totals.items()
    ))
    log(f"  launches per proof: {launches}")
    log("  poseidon2_permute launches per proof by n: " + ", ".join(
        f"{key[0]}: {count}" for key, count in sorted(shapes["poseidon2_permute"].items())
    ))
    log_phase(f"phase 4 full proof 2^{FULL_LOG} MIDEN_PARAMS, eager: {prove_s:.4f} s (one timed prove; "
        f"warm-up {warm_s:.3f} s), "
        f"peak memory {peak / 2**30:.3f} GiB, proof {len(proof_to_bytes(out.proof))} bytes, "
        f"verified in {verify_s:.3f} s")

    # -- 5. the VM facade: prove_program / verify_program --------------------
    small = assemble(fib_program(VM_SMALL_REPS))
    out_gpu, vm_gpu = prove_program(small, params=MIDEN_PARAMS, device=dev)
    drain_program_checks()
    small_cpu_bytes, cpu_s = CPU_HALVES.get("vm_fib")
    if vm_gpu.to_bytes() != small_cpu_bytes:
        raise AssertionError("VM proofs from the card and the CPU differ")
    verify_program(vm_gpu, params=MIDEN_PARAMS)
    if out_gpu.stack[0] != fib_top(VM_SMALL_REPS, gl.P):
        raise AssertionError(f"small VM program left {out_gpu.stack[0]} on top of the stack")
    log_phase(f"phase 5a VM fib repeat.{VM_SMALL_REPS} MIDEN_PARAMS: card == CPU "
        f"({len(vm_gpu.to_bytes())} bytes), log heights {vm_gpu.stark.log_heights}, verified; "
        f"CPU prove {cpu_s:.3f} s (in the CPU process)")

    full = assemble(fib_program(VM_FULL_REPS))
    # the warm-up: the first proof of vm-fib-18's shape runs the fused phases
    # eagerly, and its bytes are the reference of every later call
    fused.release()
    PROGRAM_CHECKS.eager = True  # the first vm-fib-18 proof: Q1 == the eager evaluator too
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, warm_proof = prove_program(full, params=MIDEN_PARAMS, device=dev)
    torch.cuda.synchronize()
    vm_warm_s = time.perf_counter() - t0
    vm_peak = torch.cuda.max_memory_allocated()  # the eager peak
    warm_launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
    vm_bytes = warm_proof.to_bytes()
    PROGRAM_CHECKS.eager = False
    drain_program_checks()
    # rep 0 captures the five phases into CUDA graphs and replays them; reps
    # 1-3 replay them (the median), rep 1's launches counted
    vm_times, vm_out, vm_proof = [], None, None
    for rep in range(4):
        if rep == 0:
            torch.cuda.reset_peak_memory_stats()
        if rep == 1:
            zero_counts(kernels)
            native_trace.RUNS.update({k: 0 for k in native_trace.RUNS})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vm_out, vm_proof = prove_program(full, params=MIDEN_PARAMS, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if vm_proof.to_bytes() != vm_bytes:
            raise AssertionError(f"vm-fib-18 call {rep} after the warm-up differs from the warm-up's bytes")
        if rep == 0:
            capture_s, fused_peak = secs, torch.cuda.max_memory_allocated()
            plan = fused.cached_plan()
            if plan is None or not plan.captured:
                raise AssertionError("the second vm-fib-18 proof did not capture its phases")
            phase_stats, vm_key = graph_stats(plan), plan.key
            continue
        vm_times.append(secs)
        if rep == 1:
            vm_launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
            record_shapes(kernels, vm_shapes)
            native_runs = dict(native_trace.RUNS)
    if vm_launches != warm_launches:
        raise AssertionError(f"a replayed proof's launches {vm_launches} != the eager warm-up's {warm_launches}")
    trace_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, vm_trace = execute_and_trace(full)
        trace_times.append(time.perf_counter() - t0)
    # the traced call is eager (fused=False): its per-stage spans compare with
    # earlier runs. A second traced call replays the graphs: one span a phase
    with Recorder() as vm_rec:
        prove_program(full, params=MIDEN_PARAMS, device=dev, fused=False)
    with Recorder() as phase_rec:
        prove_program(full, params=MIDEN_PARAMS, device=dev)
    t0 = time.perf_counter()
    verify_program(vm_proof, params=MIDEN_PARAMS)
    vm_verify_s = time.perf_counter() - t0
    want_top = fib_top(VM_FULL_REPS, gl.P)
    if vm_out.stack[0] != want_top:
        raise AssertionError(f"VM program left {vm_out.stack[0]}, fib mod p is {want_top}")
    check_path(vm_launches, "poseidon2", "the VM proof")
    # (c) the core rows came from the C trace generator, not the interpreter
    c_share = native_runs["rows"] / vm_trace.num_real_rows
    if native_runs["block"] == 0 or c_share < 0.99:
        raise AssertionError(f"the VM trace did not come from the C trace generator: {native_runs}")
    med, med_trace = statistics.median(vm_times), statistics.median(trace_times)
    log("  spans (traced eager prove_program, synchronized at span edges): " + "; ".join(
        f"{k} {v[0]:.4f} s" for k, v in vm_rec.totals.items()
    ))
    log("  evaluate constraints, per AIR: " + ", ".join(
        f"{air} {v[0]:.4f} s" for (name, air), v in vm_rec.by_air.items() if name == "evaluate constraints"))
    log("  spans (traced replayed prove_program): " + "; ".join(
        f"{k} {v[0]:.4f} s" for k, v in phase_rec.totals.items()))
    log(f"  launches per VM proof (a replay; == the eager warm-up's): {vm_launches}")
    log(f"  host load average after the timed calls: {os.getloadavg()[0]:.2f} over {os.cpu_count()} CPUs")
    log(f"  C trace generator: {native_runs['block']} blocks, {native_runs['rows']} of "
        f"{vm_trace.num_real_rows} real core rows ({100 * c_share:.3f} %)")
    log(f"  graphs: {phase_stats}")
    log_phase(f"phase 5b VM fib repeat.{VM_FULL_REPS} MIDEN_PARAMS: log heights {vm_proof.stark.log_heights} "
        f"(core, chiplets, poseidon); prove_program median {med:.4f} s of three replays of the phases' "
        f"CUDA graphs (runs {', '.join(f'{t:.4f}' for t in vm_times)}; the capture call {capture_s:.4f} s, "
        f"the eager warm-up {vm_warm_s:.3f} s), execute_and_trace "
        f"median {med_trace:.4f} s ({100 * med_trace / med:.1f} % of the call; runs "
        f"{', '.join(f'{t:.4f}' for t in trace_times)}), peak memory eager {vm_peak / 2**30:.3f} GiB "
        f"(the warm-up), fused {fused_peak / 2**30:.3f} GiB (the capture call), proof {len(vm_bytes)} bytes, every call == the warm-up's bytes, verified in "
        f"{vm_verify_s:.3f} s, top of stack {vm_out.stack[0]} == fib mod p")

    # -- 5e. a second program of the same shape through 5b's graphs -------------
    other = assemble(fib_program(VM_OTHER_REPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # 5b's graphs' outputs and inputs
    t0 = time.perf_counter()
    _, other_eager = prove_program(other, VM_OTHER_INPUTS, params=MIDEN_PARAMS, device=dev, fused=False)
    torch.cuda.synchronize()
    other_eager_s = time.perf_counter() - t0
    other_peak = torch.cuda.max_memory_allocated() - before  # the eager proof's own peak
    drain_program_checks()
    calls = plan.calls
    t0 = time.perf_counter()
    other_out, other_proof = prove_program(other, VM_OTHER_INPUTS, params=MIDEN_PARAMS, device=dev)
    torch.cuda.synchronize()
    other_s = time.perf_counter() - t0
    if fused.cached_plan() is not plan or plan.calls != calls + 1:
        raise AssertionError("phase 5e: the second program did not replay phase 5b's graphs")
    if other_proof.stark.log_heights != vm_proof.stark.log_heights:
        raise AssertionError(f"phase 5e: log heights {other_proof.stark.log_heights}")
    if other_proof.to_bytes() != other_eager.to_bytes():
        raise AssertionError("phase 5e: the replayed proof differs from the program's eager proof")
    if other_proof.to_bytes() == vm_bytes or other_proof.program_hash == vm_proof.program_hash:
        raise AssertionError("phase 5e: the second program proved to the first program's claim")
    verify_program(other_proof, params=MIDEN_PARAMS)
    if other_out.stack[0] != fib_top(VM_OTHER_REPS, gl.P):
        raise AssertionError(f"phase 5e: the program left {other_out.stack[0]} on top of the stack")
    # what the kept graphs held between proofs: their outputs and static
    # inputs (allocated) within their pool (reserved), freed by release()
    torch.cuda.empty_cache()
    alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    del plan
    fused.release()
    held_gib = (alloc - torch.cuda.memory_allocated()) / 2**30
    pool_gib = (reserved - torch.cuda.memory_reserved()) / 2**30
    log_phase(f"phase 5e VM fib repeat.{VM_OTHER_REPS} with stack inputs {VM_OTHER_INPUTS} MIDEN_PARAMS: "
              f"log heights {other_proof.stark.log_heights}, another program hash; replayed through phase "
              f"5b's graphs in {other_s:.4f} s == its eager proof (fused=False: {other_eager_s:.4f} s, "
              f"{other_eager_s / other_s:.2f}x the replay; its own peak {other_peak / 2**30:.3f} GiB), verified; 5b's graphs held {held_gib:.3f} GiB "
              f"allocated in {pool_gib:.3f} GiB reserved between proofs, freed by fused.release()")

    # -- 5c, 5d: the other commitment hashes; preprocessed columns --------------
    rescue_proofs = rescue_phase(torch, kernels, dev)
    preprocessed_phase(torch, dev)

    # -- 6. the precompile session ---------------------------------------------
    from miden_tpu_torch import bench_session

    session_launches, session_shapes = session_phase(torch, kernels, dev, bench_session.PINNED)

    # -- 10. the standard library: stdlib-small, -blake3-18, -host; MerkleTree --
    blake3_proof = stdlib_phase(torch, kernels, dev)

    # -- 11. the in-VM STARK verifier on vm-fib-18's proof ------------------------
    recursion_proof = recursion_phase(torch, kernels, dev, vm_proof)

    # -- 12. multi-device: NCCL at world size 1, gloo ranks sharing the card -----
    dist_proof = dist_phase(torch, kernels, full, vm_bytes, vm_peak, other_peak, small_cpu_bytes)

    # -- 7. kernels vs plain, and timings, at the proofs' shapes --------------
    rows = kernel_rows(torch, kernels, {
        "vm": (vm_launches, vm_shapes), "shaped": (launches, shapes),
        "session": (session_launches, session_shapes), **rescue_proofs, "blake3": blake3_proof,
        "recursion": recursion_proof, "dist": dist_proof,
    }, errs, rand)
    log_phase(f"phase 7 kernels vs plain and timings at the proofs' shapes on {card}")

    # -- 9. the entry surfaces: CLI, wire forms, pause/resume, byte hashes ---
    entry_phase(torch, kernels, dev, vm_launches, vm_bytes, small_cpu_bytes)

    # -- 8. device-busy share, then the result lines ---------------------------
    # the profiler runs last: after it the host's cost per launch stays up
    # (on an H100 80GB HBM3 host, 8.19 -> 13.59 us a one-element add) and
    # the session proof is 25-40 % slower (python3 -m miden_tpu_torch.bench_session)
    # a replayed call: other shapes were proved since 5b, so this shape's
    # capture comes first (and its warm-up, unless phase 9a's in-process
    # proof was the last proof)
    for _ in range(2):
        plan = fused.cached_plan()
        if plan is not None and plan.key == vm_key and plan.captured:
            break
        prove_program(full, params=MIDEN_PARAMS, device=dev)
    plan = fused.cached_plan()
    if plan is None or plan.key != vm_key or not plan.captured:
        raise AssertionError("phase 8: vm-fib-18's phases were not captured")
    del plan
    vm_busy, traced = device_busy(torch, lambda: prove_program(full, params=MIDEN_PARAMS, device=dev))
    # the launches the profiler saw on the card during the replay, against
    # the eager warm-up's counts of phase 5b
    traced = {name: traced.get(kern.symbol, 0) for name, (kern, _, _) in kernels.items()}
    if traced != warm_launches:
        raise AssertionError(f"phase 8: the profiled replay ran the port's kernels {traced} times, "
                             f"the eager warm-up {warm_launches}")
    log(f"  the port's kernels among the profiled replay's device events (== the eager warm-up's "
        f"launches): {traced}")
    log_phase(f"phase 8 profiled replayed prove_program of VM fib repeat.{VM_FULL_REPS}: {vm_busy}")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
