#!/usr/bin/env python3
"""Smoke run of the PyTorch port (miden_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (plus details):

1. build the CUDA kernels from miden_tpu_torch/csrc (one nvcc per source,
   in parallel);
2. hold each kernel entry (K1 ntt_col_transform, K2 ntt_transpose_twiddle,
   K3 poseidon2_permute, poseidon2_absorb_rows, poseidon2_compress_rows)
   against its plain torch twin on the card, exact equality, on inputs from
   a seeded numpy generator;
3. prove miden_shaped_statement(10) at MIDEN_PARAMS on the card and on the
   CPU: the proof bytes must be equal and the port's verifier must accept;
4. prove miden_shaped_statement(18) at MIDEN_PARAMS on the card (core
   2^18 x 51 with 8 EF aux columns, chiplets 2^16 x 22, perm 2^14 x 16, LDE
   2^21 rows): one warm-up, three timed proves (CUDA events), the kernel
   launch counts of one prove (per entry, and K3's permutations per
   shape), the span breakdown of one traced prove, peak memory, and the
   verifier's verdict;
5. hold each kernel against its plain twin and time it, with its bound, at
   every shape phase 4 launched it with (K1 printed at each shape);
6. the JSON line of kernels, the card's name and power limit, and the result
   line ``{"ok": true, "device": {...}}`` last.

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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    """One run of ``fn`` under torch.profiler: device kernel time against
    wall time, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        if us:
            rows.append((us, ev.key, ev.count))
    if not rows:
        return f"wall {wall:.4f} s under the profiler; device time not measured (no device events)"
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows) / 1e6
    top = "; ".join(f"{k[:60]} {us / 1e3:.2f} ms x{c}" for us, k, c in rows[:8])
    return (f"wall {wall:.4f} s under the profiler, device busy {total:.4f} s "
            f"({100 * total / wall:.1f} %); top: {top}")


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from miden_tpu_torch.bench_airs import miden_shaped_statement
    from miden_tpu_torch.bench_kernels import HBM_BYTES_PER_S, bench_case, bound_ms, time_ms
    from miden_tpu_torch.field import gl
    from miden_tpu_torch.field import goldilocks as F
    from miden_tpu_torch.hash import poseidon2
    from miden_tpu_torch.ntt import ntt
    from miden_tpu_torch.stark import MIDEN_PARAMS, prove, verify
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.transcript.challenger import DuplexChallenger
    from miden_tpu_torch.utils import cuda
    from miden_tpu_torch.utils.tracing import Recorder

    card = nvidia_smi("name,power.limit")
    kernels = {
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
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build ------------------------------------------------------------
    secs = cuda.build_all()
    for name in ("ntt", "poseidon2"):
        ptxas = [
            ln.strip() for ln in (cuda.BUILD_DIR / f"{name}.log").read_text().splitlines()
            if "registers" in ln or "spill" in ln
        ]
        log(f"  ptxas {name}: " + " | ".join(ptxas))
    log(f"phase 1 build: {secs:.3f} s for csrc/ntt.cu and csrc/poseidon2.cu")

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
    log("phase 2 kernels vs plain: all equal (tolerance 0: Goldilocks arithmetic is exact)")

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
    log(f"phase 3 small proof 2^{SMALL_LOG} MIDEN_PARAMS: card == CPU ({len(b_gpu)} bytes), "
        f"verified; CPU prove {cpu_s:.3f} s")

    # -- 4. full-size proof -------------------------------------------------
    shapes = {name: {} for name in kernels}

    def record_shapes():
        for name, (kern, _, _) in kernels.items():
            for key, count in kern.shapes.items():
                shapes[name][key] = shapes[name].get(key, 0) + count

    st, tr = miden_shaped_statement(FULL_LOG, device=dev)
    t0 = time.perf_counter()
    prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, out = [], None
    for rep in range(3):
        if rep == 0:
            for kern, _, _ in kernels.values():
                kern.launches = 0
                kern.shapes.clear()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / 1e3)
        if rep == 0:
            launches = {name: kern.launches for name, (kern, _, _) in kernels.items()}
            record_shapes()
    peak = torch.cuda.max_memory_allocated()
    with Recorder() as rec:
        prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev)
    busy = device_busy(torch, lambda: prove(MIDEN_PARAMS, st, tr, DuplexChallenger(SEED), device=dev))
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
    log(f"  profiled prove: {busy}")
    log(f"phase 4 full proof 2^{FULL_LOG} MIDEN_PARAMS: median {statistics.median(times):.4f} s "
        f"(runs {', '.join(f'{t:.4f}' for t in times)}; warm-up {warm_s:.3f} s), "
        f"peak memory {peak / 2**30:.3f} GiB, proof {len(proof_to_bytes(out.proof))} bytes, "
        f"verified in {verify_s:.3f} s")

    # -- 5. kernels vs plain, and timings, at the main path's shapes ---------
    # random inputs at every shape phase 4 launched: the proof's own traces
    # are zeros, so its launches alone would not show the kernels right there
    mul_rate = int32_mul_rate(torch)
    rows = []
    for name, (kern, source, replaces) in kernels.items():
        total_ms, top = 0.0, None
        for key, count in sorted(shapes[name].items()):
            bench = bench_case(ntt, poseidon2, rand, name, key)
            errs[name] = max(errs[name], max_abs_err(bench["kernel"](), bench["plain"]()))
            ms = time_ms(bench["kernel"], bench["reps"])
            total_ms += ms * count
            if name == "ntt_col_transform":
                k_bound = bound_ms(bench, mul_rate)
                log(f"    {name} at {key}: {ms:.4f} ms/launch x {count}, bound {k_bound:.4f} ms "
                    f"({100 * k_bound / ms:.1f} % of bound)")
            if top is None or bench["elems"] > top[1]["elems"]:
                top = (key, bench, ms, count)
        log(f"  {name}: kernel == plain at all {len(shapes[name])} shapes of the proof, "
            f"max |diff| {errs[name]}")
        if errs[name]:
            raise AssertionError(f"{name} disagrees with its plain version at the proof's shapes")
        key, bench, ms, count = top
        plain_ms = time_ms(bench["plain"], 2)
        b_ms = bound_ms(bench, mul_rate)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6), "bound_ms": round(b_ms, 6),
            "bound_by": "bytes" if bench["bytes"] / HBM_BYTES_PER_S >= bench["ops"] / mul_rate
            else "operations",
            "library_ms": None, "shape": list(key), "launches_at_shape": count,
            "ms_per_proof": round(total_ms, 6),
        }
        if "copy" in bench:  # the bare transpose copy, a yardstick for K2
            row["copy_ms"] = round(time_ms(bench["copy"], bench["reps"]), 6)
        rows.append(row)
        log(f"  {name} at {key}: {ms:.4f} ms/launch (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {row['bound_by']}); {launches[name]} launches/proof over {len(shapes[name])} shapes, "
            f"{total_ms:.3f} ms/proof")
    log(f"phase 5 kernels vs plain and timings at the proof's shapes on {card}")

    # -- 6. result lines ----------------------------------------------------
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
