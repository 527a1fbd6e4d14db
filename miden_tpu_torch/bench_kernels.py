"""Kernel timings on one card: the cases ``chip_smoke.py`` times, and an A/B
of this tree's kernels against an earlier checkout's.

    python3 -m miden_tpu_torch.bench_kernels --parent DIR [--log-core 18]

``DIR`` is the root of a checkout of an earlier commit of this repository
(for example ``git archive <commit> | tar -x -C _checkout/parent``). Its
``miden_tpu_torch`` is loaded beside this one under another name, builds its
kernels into its own ``_build`` and is driven only through its own entry
points, so the A/B does not depend on its kernels' interfaces or tilings.
The script

1. builds both trees' kernels and prints for each build the ptxas registers
   and spills of each kernel, and the SASS opcode counts of each kernel and
   of one Goldilocks multiply and one add (probe kernels compiled against
   the tree's ``goldilocks.cuh``, from ``cuobjdump -sass``);
2. proves ``miden_shaped_statement(log_core)`` at ``MIDEN_PARAMS`` once with
   each tree, to record the shapes each launches its kernels with;
3. for every kernel both trees have, times the two in turns (earlier, this,
   this, earlier) on the same random inputs at each shape both launched,
   after checking that they agree; then each tree's kernel time per proof
   (launches x ms per launch, over its own shapes), per kernel and for K3's
   entries together.

Every time is CUDA events over a run of launches, in ms per launch. It needs
one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

#: H100 SXM HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: general Goldilocks multiplies per Poseidon2 permutation: 8 external rounds
#: x 12 S-boxes x 4, plus 22 internal rounds x 4 (the lane-0 S-box). The
#: internal diagonal needs none: MAT_DIAG's entries are ±2^k, ±3 and ±2^-k,
#: products by shifts and adds
MULS_PER_PERM = 8 * 12 * 4 + 22 * 4
#: 32-bit multiplies per Goldilocks multiply: the 64x64 -> 128-bit product
#: is four 32x32 -> 64 partial products, each a low and a high half
INT32_MULS_PER_MUL = 8

#: kernel symbol -> (module under the package, attribute of its cuda.Kernel)
KERNELS = {
    "ntt_col_transform": ("ntt.ntt", "COL_KERNEL"),
    "ntt_transpose_twiddle": ("ntt.ntt", "TRANSPOSE_KERNEL"),
    "poseidon2_permute": ("hash.poseidon2", "PERMUTE_KERNEL"),
    "poseidon2_absorb_rows": ("hash.poseidon2", "ABSORB_KERNEL"),
    "poseidon2_compress_rows": ("hash.poseidon2", "COMPRESS_KERNEL"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls after one."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(a, b, reps: int) -> tuple:
    """(a, b) ms as the means of a, b, b, a."""
    ta1, tb1, tb2, ta2 = time_ms(a, reps), time_ms(b, reps), time_ms(b, reps), time_ms(a, reps)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def bound_ms(case: dict, mul_rate: float) -> float:
    """Least ms the card could take for one launch: the larger of bytes over
    the HBM rate and 32-bit multiplies over ``mul_rate`` (per second)."""
    return max(case["bytes"] / HBM_BYTES_PER_S, case["ops"] / mul_rate) * 1e3


def bench_case(ntt, poseidon2, rand, name: str, key: tuple) -> dict:
    """Random inputs for one launch of kernel ``name`` at the recorded shape
    ``key``: the kernel call (through the wrappers of the given ``ntt`` and
    ``poseidon2`` modules), its plain twin, and the bytes and 32-bit
    multiplies the launch needs."""
    if name == "poseidon2_permute":
        (n,) = key
        s = rand((12, n))
        return {
            "kernel": lambda: poseidon2.permute_kernel(s), "plain": lambda: poseidon2.permute_plain(s),
            "elems": 12 * n, "bytes": 2 * 12 * n * 8,
            "ops": MULS_PER_PERM * INT32_MULS_PER_MUL * n, "reps": 20 if n > 4096 else 200,
        }
    if name == "poseidon2_absorb_rows":
        max_h, h, w = key
        s, m = rand((12, max_h)), rand((h, w))
        return {
            "kernel": lambda: poseidon2.absorb_rows_kernel(s, m),
            "plain": lambda: poseidon2.absorb_rows_plain(s, m),
            "elems": max_h * w, "bytes": (h * w + 2 * 12 * max_h) * 8,
            "ops": -(-w // 8) * MULS_PER_PERM * INT32_MULS_PER_MUL * max_h,
            "reps": 10 if max_h > 4096 else 100,
        }
    if name == "poseidon2_compress_rows":
        (m,) = key
        cur = rand((2 * m, 4))
        return {
            "kernel": lambda: poseidon2.compress_rows_kernel(cur),
            "plain": lambda: poseidon2.compress_rows_plain(cur),
            "elems": m, "bytes": (2 * m * 4 + m * 4) * 8,
            "ops": MULS_PER_PERM * INT32_MULS_PER_MUL * m, "reps": 20 if m > 4096 else 200,
        }
    if name == "ntt_col_transform":
        log_n, m, dit, inverse = key
        x = rand((1 << log_n, m))
        return {
            "kernel": lambda: ntt.col_transform_kernel(x, inverse, dit),
            "plain": lambda: ntt.transform_plain(x, inverse, dit),
            "elems": x.numel(), "bytes": (2 * x.numel() + (1 << log_n) - 1) * 8,
            "ops": (x.numel() // 2) * log_n * INT32_MULS_PER_MUL,
            "reps": 20 if x.numel() > 1 << 16 else 200,
        }
    assert name == "ntt_transpose_twiddle", name
    a, b, w, mode = key
    x = rand((a, b, w))
    tw = rand((a, b) if mode == 1 else (b, a)) if mode else None
    return {
        "kernel": lambda: ntt.transpose_twiddle_kernel(x, tw, mode),
        "plain": lambda: ntt.transpose_twiddle_plain(x, tw, mode),
        "copy": lambda: x.transpose(0, 1).contiguous(),
        "elems": x.numel(), "bytes": (2 * x.numel() + (a * b if mode else 0)) * 8,
        "ops": x.numel() * INT32_MULS_PER_MUL if mode else 0,
        "reps": 20 if x.numel() > 1 << 16 else 200,
    }


# ---------------------------------------------------------------------------
# What the compiler made
# ---------------------------------------------------------------------------

PROBE = r"""
#include "goldilocks.cuh"
extern "C" __global__ void probe_mul8(const unsigned long long* a, const unsigned long long* b,
                                      unsigned long long* o) {
  const int i = threadIdx.x;
  unsigned long long x = a[i];
  const unsigned long long y = b[i];
#pragma unroll
  for (int k = 0; k < 8; ++k) x = gl::mul(x, y);
  o[i] = x;
}
extern "C" __global__ void probe_add8(const unsigned long long* a, const unsigned long long* b,
                                      unsigned long long* o) {
  const int i = threadIdx.x;
  unsigned long long x = a[i];
  const unsigned long long y = b[i];
#pragma unroll
  for (int k = 0; k < 8; ++k) x = gl::add(x, y);
  o[i] = x;
}
"""

_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise SystemExit(f"{name} not found")
    return path


def sass_opcodes(binary: Path) -> dict:
    """{function name: Counter of SASS opcodes (without modifiers)}."""
    text = subprocess.run(
        [_tool("cuobjdump"), "-sass", str(binary)], capture_output=True, text=True, check=True
    ).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = collections.Counter()
        elif fn is not None:
            m = _OPCODE.search(line)
            if m:
                out[fn][m.group(1)] += 1
    return out


def _summary(counts: collections.Counter, per: int = 1) -> str:
    total = sum(counts.values())
    keys = ("IMAD", "IADD3", "ISETP", "SEL", "LOP3", "SHF")
    parts = [f"{k} {counts.get(k, 0) / per:g}" for k in keys]
    return f"total {total / per:g} ({', '.join(parts)})"


def report_build(label: str, cuda) -> None:
    """ptxas and SASS of the kernel libraries of the tree whose
    ``utils.cuda`` module is ``cuda``, and of the probe kernels against its
    ``goldilocks.cuh``."""
    probe = cuda.BUILD_DIR / "probe.cubin"
    (cuda.BUILD_DIR / "probe.cu").write_text(PROBE)
    subprocess.run(
        [_tool("nvcc"), "-cubin", "-arch=sm_90a", "-O3", "-I", str(cuda.CSRC),
         "-o", str(probe), str(cuda.BUILD_DIR / "probe.cu")],
        check=True, capture_output=True,
    )
    for name in ("ntt", "poseidon2"):
        lines = [ln.strip() for ln in (cuda.BUILD_DIR / f"{name}.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"  {label} ptxas {name}: " + " | ".join(lines))
        for fn, counts in sass_opcodes(cuda.BUILD_DIR / f"lib{name}.so").items():
            log(f"  {label} SASS {fn[:90]}: {_summary(counts)}")
    for fn, counts in sass_opcodes(probe).items():
        log(f"  {label} SASS {fn} per operation (8 chained): {_summary(counts, 8)}")


# ---------------------------------------------------------------------------
# The A/B
# ---------------------------------------------------------------------------


class Tree:
    """One checkout's ``miden_tpu_torch``, imported under ``alias``."""

    def __init__(self, root: Path, alias: str):
        if alias not in sys.modules:
            pkg = root / "miden_tpu_torch"
            spec = importlib.util.spec_from_file_location(
                alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)]
            )
            module = importlib.util.module_from_spec(spec)
            sys.modules[alias] = module
            spec.loader.exec_module(module)
        self.alias = alias

    def mod(self, name: str):
        return importlib.import_module(f"{self.alias}.{name}")

    def kernels(self) -> dict:
        """{symbol: cuda.Kernel} of the kernels this tree has."""
        out = {}
        for symbol, (module, attr) in KERNELS.items():
            kern = getattr(self.mod(module), attr, None)
            if kern is not None:
                out[symbol] = kern
        return out

    def record_shapes(self, log_core: int) -> dict:
        """{symbol: {key: launches}} of one proof of the shaped statement."""
        st, tr = self.mod("bench_airs").miden_shaped_statement(log_core)
        stark = self.mod("stark")
        challenger = self.mod("transcript.challenger").DuplexChallenger([1, 2, 3, 4])
        kernels = self.kernels()
        for kern in kernels.values():
            kern.launches = 0
            kern.shapes.clear()
        stark.prove(stark.MIDEN_PARAMS, st, tr, challenger)
        torch.cuda.synchronize()
        return {symbol: dict(kern.shapes) for symbol, kern in kernels.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--log-core", type=int, default=18)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    trees = {"parent": Tree(args.parent.resolve(), "parent_miden_tpu_torch"),
             "this": Tree(Path(__file__).resolve().parents[1], __package__)}
    # -- 1. builds and what the compiler made --------------------------------
    for label, tree in trees.items():
        cuda = tree.mod("utils.cuda")
        cuda.build_all()
        report_build(label, cuda)

    # -- 2. the shapes of one proof, per tree --------------------------------
    shapes = {label: tree.record_shapes(args.log_core) for label, tree in trees.items()}
    for label in trees:
        log(f"{label} launches per proof: " + ", ".join(
            f"{sym} {sum(s.values())}" for sym, s in shapes[label].items()))

    # -- 3. in turns at common shapes, and per proof -------------------------
    F, gl = trees["this"].mod("field.goldilocks"), trees["this"].mod("field.gl")

    def seeded(seed):
        gen = np.random.default_rng(seed)
        return lambda shape: F.to_torch(gen.integers(0, gl.P, size=shape, dtype=np.uint64), "cuda")

    mods = {label: (t.mod("ntt.ntt"), t.mod("hash.poseidon2")) for label, t in trees.items()}
    per_proof = {label: collections.Counter() for label in trees}
    for symbol in KERNELS:
        have = [label for label in trees if symbol in shapes[label]]
        keys = sorted(set().union(*(shapes[label][symbol] for label in have)))
        for seed, key in enumerate(keys):
            # the same seed gives both trees the same inputs
            cases = {label: bench_case(*mods[label], seeded(seed), symbol, key)
                     for label in have if key in shapes[label][symbol]}
            if len(cases) == 2:
                old, new = cases["parent"]["kernel"], cases["this"]["kernel"]
                if not torch.equal(old(), new()):
                    raise AssertionError(f"{symbol} at {key}: the trees disagree")
                ms = dict(zip(("parent", "this"), in_turns(old, new, cases["this"]["reps"])))
            else:
                ms = {label: time_ms(c["kernel"], c["reps"]) for label, c in cases.items()}
            for label, t in ms.items():
                per_proof[label][symbol] += shapes[label][symbol][key] * t
            speedup = f" ({ms['parent'] / ms['this']:.2f}x)" if len(ms) == 2 else ""
            log(f"  {symbol} {key}: " + ", ".join(
                f"{label} {t:.4f} ms x{shapes[label][symbol][key]}" for label, t in ms.items()) + speedup)
    for label in trees:
        k3 = sum(v for s, v in per_proof[label].items() if s.startswith("poseidon2_"))
        log(f"{label} ms per proof: " + ", ".join(
            f"{s} {v:.4f}" for s, v in per_proof[label].items()) + f"; K3 entries together {k3:.4f}")
    log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
