"""Kernel timings on one card: the cases ``chip_smoke.py`` times, and an A/B
of this tree's kernels against an earlier checkout's.

    python3 -m miden_tpu_torch.bench_kernels --parent DIR

``DIR`` is the root of a checkout of an earlier commit of this repository
(for example ``git archive <commit> | tar -x -C _checkout/parent``). Its
``miden_tpu_torch`` is loaded beside this one under another name, builds its
kernels into its own ``_build`` and is driven only through its own entry
points, so the A/B does not depend on its kernels' interfaces or tilings.
The A/B

1. builds both trees' kernels and prints for each build the ptxas registers,
   stack frame and spills of each kernel (K1-K3, and R1 RPO-256 and R2
   RPX-256 where the tree has ``csrc/rescue.cu``), and the SASS opcode counts
   of each kernel and of one Goldilocks multiply and one add (probe kernels
   compiled against the tree's ``goldilocks.cuh``, from ``cuobjdump -sass``);
   then the SASS mix of one RPO and one RPX permutation of this tree's
   ``csrc/rescue.cu`` (:func:`rescue_mix`);
2. proves the VM fib program of vm-fib-18 (``bench_quotient.FIB_18``, core
   2^18) with ``prove_program`` at ``MIDEN_PARAMS`` once under each
   commitment hash both trees have (poseidon2, and rpo256 and rpx256 where
   both have R1 / R2) with each tree, records the shapes each launches its
   kernels with, and checks that the two trees' proof bytes are equal under
   each hash;
3. for every kernel both trees have, times the two in turns (earlier, this,
   this, earlier) on the same random inputs at each shape both launched,
   after checking that they agree; then each tree's kernel time over those
   proofs (launches x ms per launch, over its own shapes), per kernel and
   for each permutation's entries together.

Every time is CUDA events over a run of launches, in ms per launch. It needs
one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
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
#: 32-bit multiplies per Goldilocks product: a general 64x64 -> 128-bit
#: product is four 32x32 -> 64 partial products, each a low and a high half;
#: a square needs three (lo*lo, hi*hi, and lo*hi once, doubled)
INT32_MULS_PER_MUL, INT32_MULS_PER_SQUARE = 8, 6
#: x^7 as x^2, x^4 (squares) and x^3, x^7 (products)
_X7 = 2 * INT32_MULS_PER_SQUARE + 2 * INT32_MULS_PER_MUL
#: x^(1/7) by the reference's addition chain: 63 squares and 9 products
_X_INV7 = 63 * INT32_MULS_PER_SQUARE + 9 * INT32_MULS_PER_MUL
#: x^7 in F_p[phi]/(phi^3 - phi - 1): two extension squares and two
#: extension products, each 6 base squares / products (Karatsuba)
_X7_EXT3 = 2 * 6 * INT32_MULS_PER_SQUARE + 2 * 6 * INT32_MULS_PER_MUL
#: 32-bit multiplies per permutation. Poseidon2: 8 external rounds x 12
#: S-boxes plus 22 internal rounds x 1 (the internal diagonal needs none:
#: MAT_DIAG's entries are ±2^k, ±3 and ±2^-k, products by shifts and adds).
#: RPO: 7 rounds x 12 lanes x (x^7 + x^(1/7)). RPX: 3 such rounds, plus 3 E
#: rounds of four cubic-extension x^7. The MDS of RPO / RPX is multiply-adds
#: by constants <= 26, not counted.
INT32_MULS_PER_PERM = {
    "poseidon2": (8 * 12 + 22) * _X7,
    "rpo": 7 * 12 * (_X7 + _X_INV7),
    "rpx": 3 * 12 * (_X7 + _X_INV7) + 3 * 4 * _X7_EXT3,
}

#: kernel symbol -> (module under the package, attribute path of its cuda.Kernel)
KERNELS = {
    "ntt_col_transform": ("ntt.ntt", "COL_KERNEL"),
    "ntt_transpose_twiddle": ("ntt.ntt", "TRANSPOSE_KERNEL"),
    "poseidon2_permute": ("hash.poseidon2", "PERMUTE_KERNEL"),
    "poseidon2_absorb_rows": ("hash.poseidon2", "ABSORB_KERNEL"),
    "poseidon2_compress_rows": ("hash.poseidon2", "COMPRESS_KERNEL"),
    **{f"{name}_{entry}": ("hash.rescue", f"{name.upper()}.{attr}")
       for name in ("rpo", "rpx")
       for entry, attr in (("permute", "PERMUTE_KERNEL"), ("absorb_rows", "ABSORB_KERNEL"),
                           ("compress_rows", "COMPRESS_KERNEL"))},
    # Q1 runs a recorded program on a proof's own inputs: bench_quotient and
    # chip_smoke time it there; it has no random-input case below
    "constraints_eval": ("stark.interp", "Q1_KERNEL"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls, after one
    unless ``warm`` is False (a plain twin, which has nothing to warm up and
    may take seconds a call)."""
    if warm:
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


def int32_mul_rate() -> float:
    """32-bit integer multiplies per second: 64 INT32 lanes per SM per clock
    (Hopper SM) x SMs x the card's maximum SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0]
    return 64 * torch.cuda.get_device_properties(0).multi_processor_count * float(mhz) * 1e6


def bound_ms(case: dict, mul_rate: float) -> float:
    """Least ms the card could take for one launch: the larger of bytes over
    the HBM rate and 32-bit multiplies over ``mul_rate`` (per second)."""
    return max(case["bytes"] / HBM_BYTES_PER_S, case["ops"] / mul_rate) * 1e3


def sponges(tree_mod) -> dict:
    """{permutation name: the object with its entries} of one tree
    (``tree_mod(name)`` imports a module of the tree's package): the
    Poseidon2 module itself, and RPO / RPX where the tree has them."""
    out = {"poseidon2": tree_mod("hash.poseidon2")}
    try:
        rescue = tree_mod("hash.rescue")
    except ImportError:
        return out
    return {**out, "rpo": rescue.RPO, "rpx": rescue.RPX}


#: permutation name -> the PcsParams.hash_name whose trees it builds
HASH_NAMES = {"poseidon2": "poseidon2", "rpo": "rpo256", "rpx": "rpx256"}


def bench_case(ntt, sponge_map, rand, name: str, key: tuple) -> dict:
    """Random inputs for one launch of kernel ``name`` at the recorded shape
    ``key``: the kernel call (through the wrappers of the given ``ntt``
    module and the sponges of :func:`sponges`), its plain twin, and the
    bytes and 32-bit multiplies the launch needs. An NTT case has ``check``
    (the kernel's output and the twin's); a sponge entry has ``states``,
    ``perms`` (permutations of the launch) and ``at(idx)``: the kernel's
    output at the states ``idx`` (a 1-d index tensor) and the twin's over
    those states alone (each state is independent of the others)."""
    perm, _, entry = name.partition("_")
    if perm in INT32_MULS_PER_PERM:
        sp = sponge_map[perm]
        ops_per_perm = INT32_MULS_PER_PERM[perm]
        if entry == "permute":
            (n,) = key
            s = rand((12, n))
            return {
                "kernel": lambda: sp.permute_kernel(s), "plain": lambda: sp.permute_plain(s),
                "at": lambda idx: (sp.permute_kernel(s)[:, idx], sp.permute_plain(s[:, idx])),
                "states": n, "perms": n,
                "elems": 12 * n, "bytes": 2 * 12 * n * 8,
                "ops": ops_per_perm * n, "reps": 20 if n > 4096 else 200,
            }
        if entry == "absorb_rows":
            max_h, h, w = key
            s, m = rand((12, max_h)), rand((h, w))
            blocks = -(-w // 8)
            return {
                "kernel": lambda: sp.absorb_rows_kernel(s, m),
                "plain": lambda: sp.absorb_rows_plain(s, m),
                # state j takes row j mod h
                "at": lambda idx: (sp.absorb_rows_kernel(s, m)[:, idx],
                                   sp.absorb_rows_plain(s[:, idx], m[idx % h])),
                "states": max_h, "perms": blocks * max_h,
                "elems": max_h * w, "bytes": (h * w + 2 * 12 * max_h) * 8,
                "ops": blocks * ops_per_perm * max_h,
                "reps": 10 if max_h > 4096 else 100,
            }
        assert entry == "compress_rows", name
        (m,) = key
        cur = rand((2 * m, 4))
        return {
            "kernel": lambda: sp.compress_rows_kernel(cur),
            "plain": lambda: sp.compress_rows_plain(cur),
            # state i takes rows 2i and 2i + 1
            "at": lambda idx: (sp.compress_rows_kernel(cur)[idx],
                               sp.compress_rows_plain(cur.view(m, 8)[idx].reshape(-1, 4))),
            "states": m, "perms": m,
            "elems": m, "bytes": (2 * m * 4 + m * 4) * 8,
            "ops": ops_per_perm * m, "reps": 20 if m > 4096 else 200,
        }
    if name == "ntt_col_transform":
        log_n, m, dit, inverse = key
        x = rand((1 << log_n, m))
        return {
            "kernel": lambda: ntt.col_transform_kernel(x, inverse, dit),
            "plain": lambda: ntt.transform_plain(x, inverse, dit),
            "check": lambda: (ntt.col_transform_kernel(x, inverse, dit), ntt.transform_plain(x, inverse, dit)),
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
        "check": lambda: (ntt.transpose_twiddle_kernel(x, tw, mode), ntt.transpose_twiddle_plain(x, tw, mode)),
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
    for name in sorted(p.stem for p in cuda.CSRC.glob("*.cu")):
        lines = [ln.strip() for ln in (cuda.BUILD_DIR / f"{name}.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"  {label} ptxas {name}: " + " | ".join(lines))
        for fn, counts in sass_opcodes(cuda.BUILD_DIR / f"lib{name}.so").items():
            log(f"  {label} SASS {fn[:90]}: {_summary(counts)}")
    for fn, counts in sass_opcodes(probe).items():
        log(f"  {label} SASS {fn} per operation (8 chained): {_summary(counts, 8)}")


_FULL_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9.]*)")

#: SASS classes of the mix: the multiplier's 64-bit-result forms (a high
#: half each), its other forms (32-bit products, and the moves, shifts and
#: adds ptxas issues to it), and the integer ALU's
MIX_CLASSES = {
    "IMAD.WIDE/HI": lambda op: op.startswith(("IMAD.WIDE", "IMAD.HI")),
    "IMAD other": lambda op: op.startswith("IMAD"),
    "IADD3": lambda op: op.startswith("IADD3"),
    "LOP3/SHF": lambda op: op.startswith(("LOP3", "SHF")),
    "ISETP/SEL": lambda op: op.startswith(("ISETP", "SEL")),
}

#: probe kernels of the Rescue arithmetic, compiled with csrc/rescue.cu in
#: their unit: each chains N operations (N = 8, or 2 for the cubic-extension
#: and MDS ones) on its thread's own values (so that none runs on the
#: uniform datapath), and the same kernel with N = 0 is its load/store
#: frame.
RESCUE_PROBE = r"""
#include "rescue.cu"
typedef uint64_t u64;
template <int N> __device__ void sq_(u64* x) { u64 v = x[threadIdx.x];
#pragma unroll
  for (int k = 0; k < N; ++k) v = sq(v); x[threadIdx.x] = v; }
template <int N> __device__ void mul_(u64* x) { u64 v = x[threadIdx.x]; const u64 y = x[threadIdx.x + 64];
#pragma unroll
  for (int k = 0; k < N; ++k) v = mul(v, y); x[threadIdx.x] = v; }
template <int N> __device__ void canon_(u64* x) { u64 v = x[threadIdx.x];
#pragma unroll
  for (int k = 0; k < N; ++k) v = gl::canon(v) ^ (u64)k; x[threadIdx.x] = v; }
template <int N> __device__ void add_(u64* x) { u64 v = x[threadIdx.x]; const u64 y = x[threadIdx.x + 64];
#pragma unroll
  for (int k = 0; k < N; ++k) v = gl::add(v, y); x[threadIdx.x] = v; }
template <int N> __device__ void c3sqr_(u64* p) { u64* x = p + 16 * threadIdx.x; u64 a[3] = {x[0], x[1], x[2]};
#pragma unroll
  for (int k = 0; k < N; ++k) { u64 o[3]; c3_sqr(a, o); a[0] = o[0]; a[1] = o[1]; a[2] = o[2]; }
  x[0] = a[0]; x[1] = a[1]; x[2] = a[2]; }
template <int N> __device__ void c3mul_(u64* p) { u64* x = p + 16 * threadIdx.x; u64 a[3] = {x[0], x[1], x[2]};
  const u64 b[3] = {x[3], x[4], x[5]}, bs[3] = {x[6], x[7], x[8]};
#pragma unroll
  for (int k = 0; k < N; ++k) { u64 o[3]; c3_mul(a, b, bs, o); a[0] = o[0]; a[1] = o[1]; a[2] = o[2]; }
  x[0] = a[0]; x[1] = a[1]; x[2] = a[2]; }
template <int N> __device__ void mds_(u64* p) { u64* x = p + 16 * threadIdx.x; u64 s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = x[i];
#pragma unroll
  for (int k = 0; k < N; ++k) mds(s);
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = s[i]; }
#define PROBE(op, n) \
  extern "C" __global__ void mix_##op##_##n(u64* x) { op##_<n>(x); }
#define PROBES(op, n) PROBE(op, n) PROBE(op, 0)
PROBES(sq, 8) PROBES(mul, 8) PROBES(canon, 8) PROBES(add, 8) PROBES(c3sqr, 2) PROBES(c3mul, 2)
PROBES(mds, 2)
"""


def _mix(counts: collections.Counter) -> collections.Counter:
    """A full-opcode Counter folded into MIX_CLASSES, "other" and "all"."""
    out = collections.Counter()
    for op, n in counts.items():
        cls = next((c for c, match in MIX_CLASSES.items() if match(op)), "other")
        out[cls] += n
        out["all"] += n
    return out


def rescue_mix(cuda) -> dict:
    """SASS instructions of one RPO and one RPX permutation of this tree's
    ``csrc/rescue.cu`` ({"rpo": Counter, "rpx": Counter} by
    :data:`MIX_CLASSES`): each operation's count from the probe kernels of
    :data:`RESCUE_PROBE` (the N-operation kernel less its N = 0 frame, over
    N), times the operations of a permutation. A lane-round of RPO is x^7
    (2 squares, 2 products) and x^(1/7) (63 squares, 9 products), each chain
    ending in one gl::canon; a round adds 2 MDS and 24 gl::add. RPX's E
    round is 12 gl::add and, per chunk, 2 cubic squares, 2 Karatsuba
    products and the 3 gl::add of the operand sums. The moves and selects of
    the lockstep chain and of the rotations are not in the count."""
    src, cubin = cuda.BUILD_DIR / "rescue_mix.cu", cuda.BUILD_DIR / "rescue_mix.cubin"
    src.write_text(RESCUE_PROBE)
    built = subprocess.run(
        [_tool("nvcc"), "-cubin", "-arch=sm_90a", "-std=c++17", "-O3", "-I", str(cuda.CSRC),
         "-I", str(cuda.BUILD_DIR), "-o", str(cubin), str(src)],
        capture_output=True, text=True,
    )
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed for the Rescue probe kernels:\n{built.stdout}{built.stderr}")
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    fns, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fns[fn] = collections.Counter()
        elif fn is not None:
            m = _FULL_OPCODE.search(line)
            if m:
                fns[fn][m.group(1)] += 1
    per_op = {}
    for name in [f for f in fns if f.startswith("mix_") and not f.endswith("_0")]:
        op, n = name[len("mix_"):].rsplit("_", 1)
        full, frame = _mix(fns[name]), _mix(fns[f"mix_{op}_0"])
        per_op[op] = collections.Counter({k: (full[k] - frame[k]) / int(n) for k in full})

    def total(ops: dict) -> collections.Counter:
        out = collections.Counter()
        for op, count in ops.items():
            for k, v in per_op[op].items():
                out[k] += count * v
        return out

    fb = {"sq": 12 * 65, "mul": 12 * 11, "canon": 12 * 2, "mds": 2, "add": 24}
    e = {"add": 12 + 4 * 3, "c3sqr": 8, "c3mul": 8}
    last = {"mds": 1, "add": 12}
    rpx = collections.Counter()
    for ops, times in ((fb, 3), (e, 3), (last, 1)):
        for k, v in ops.items():
            rpx[k] += times * v
    mixes = {"rpo": total({k: 7 * v for k, v in fb.items()}), "rpx": total(rpx)}
    for op, counts in sorted(per_op.items()):
        log(f"  SASS per operation {op}: " + ", ".join(f"{k} {v:g}" for k, v in sorted(counts.items())))
    for perm, counts in mixes.items():
        log(f"  SASS per permutation, {perm}: " + ", ".join(
            f"{k} {v:.0f}" for k, v in sorted(counts.items())))
    return mixes


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
        for symbol, (module, path) in KERNELS.items():
            try:
                kern = self.mod(module)
            except ImportError:
                continue
            for attr in path.split("."):
                kern = getattr(kern, attr, None)
            if kern is not None:
                out[symbol] = kern
        return out

    def record_shapes(self, hash_names: list) -> tuple:
        """({symbol: {key: launches}} of one VM fib-18 proof under each of
        ``hash_names``, together; {hash name: proof bytes})."""
        vm, prove = self.mod("vm"), self.mod("vm.prove")
        program = vm.assemble(self.mod("bench_quotient").FIB_18)
        kernels = self.kernels()
        for kern in kernels.values():
            kern.launches = 0
            kern.shapes.clear()
        proofs = {}
        for hash_name in hash_names:
            params = dataclasses.replace(self.mod("stark").MIDEN_PARAMS, hash_name=hash_name)
            _, proof = prove.prove_program(program, params=params, device="cuda")
            proofs[hash_name] = proof.to_bytes()
        torch.cuda.synchronize()
        return {symbol: dict(kern.shapes) for symbol, kern in kernels.items()}, proofs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    trees = {
        "parent": Tree(args.parent.resolve(), "parent_miden_tpu_torch"),
        "this": Tree(Path(__file__).resolve().parents[1], __package__),
    }
    # -- 1. builds and what the compiler made --------------------------------
    for label, tree in trees.items():
        cuda = tree.mod("utils.cuda")
        cuda.build_all()
        report_build(label, cuda)
    rescue_mix(trees["this"].mod("utils.cuda"))

    # -- 2. the shapes of one VM proof under each common hash, per tree ------
    common = set.intersection(*(set(sponges(t.mod)) for t in trees.values()))
    hash_names = [h for perm, h in HASH_NAMES.items() if perm in common]
    shapes, proofs = {}, {}
    for label, tree in trees.items():
        shapes[label], proofs[label] = tree.record_shapes(hash_names)
        torch.cuda.empty_cache()  # a VM proof peaks near 70 GiB: leave the other tree the card
    for hash_name in hash_names:
        if proofs["parent"][hash_name] != proofs["this"][hash_name]:
            raise AssertionError(f"vm-fib-18 under {hash_name}: the trees' proof bytes differ")
    log(f"proofs: one VM fib-18 proof under each of {hash_names}; the trees' proof bytes are equal "
        "under each (" + ", ".join(f"{h} {len(proofs['this'][h])} bytes" for h in hash_names) + ")")
    for label in trees:
        log(f"{label} launches over the proofs: " + ", ".join(
            f"{sym} {sum(s.values())}" for sym, s in shapes[label].items()))

    # -- 3. in turns at common shapes, and per proof -------------------------
    F, gl = trees["this"].mod("field.goldilocks"), trees["this"].mod("field.gl")

    def seeded(seed):
        gen = np.random.default_rng(seed)
        return lambda shape: F.to_torch(gen.integers(0, gl.P, size=shape, dtype=np.uint64), "cuda")

    mods = {label: (t.mod("ntt.ntt"), sponges(t.mod)) for label, t in trees.items()}
    per_proof = {label: collections.Counter() for label in trees}
    for symbol in KERNELS:
        if symbol == "constraints_eval":
            continue
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
        together = "; ".join(
            f"{perm} entries together {sum(v for s, v in per_proof[label].items() if s.startswith(perm + '_')):.4f}"
            for perm in INT32_MULS_PER_PERM
        )
        log(f"{label} ms over the proofs: " + ", ".join(
            f"{s} {v:.4f}" for s, v in per_proof[label].items()) + f"; {together}")
    log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
