"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``_build/lib<name>.so``), loaded with
``ctypes``. Libraries are built at first use, or all at once (one ``nvcc``
per source, run in parallel) by :func:`build_all`. Nothing is built or
loaded when a module is imported.

Every exported launcher takes the pointers and the stream as ``void*`` and
returns the CUDA error of its launch; :meth:`Kernel.launch` raises when it is
not 0 and otherwise adds one to the kernel's ``launches`` count. A launch
made while a CUDA graph is captured under :func:`recording_launches` is
counted on each replay of that graph instead (:meth:`LaunchLog.replay`),
once :func:`graph_kernel_nodes` has found it among the graph's nodes.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: dict = {}
_recording = None  # the LaunchLog of the graph capture in progress


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class LaunchLog:
    """The kernel launches recorded into one CUDA graph, ``{(kernel, shape
    key): count}``: :meth:`replay` adds them to the kernels' counts, once
    for each replay of the graph."""

    def __init__(self):
        self.counts: dict = {}

    def add(self, kernel: "Kernel", key) -> None:
        self.counts[(kernel, key)] = self.counts.get((kernel, key), 0) + 1

    def total(self) -> int:
        return sum(self.counts.values())

    def per_kernel(self) -> dict:
        """``{kernel: count}`` over every shape key."""
        out: dict = {}
        for (kernel, _key), n in self.counts.items():
            out[kernel] = out.get(kernel, 0) + n
        return out

    def replay(self) -> None:
        for (kernel, key), n in self.counts.items():
            kernel.count(key, n)


def source_names(name: str) -> set:
    """The source names in a device function's name, mangled (``_Z...``, as
    the CUDA driver API gives it) or demangled (as the profiler does): among them the
    function's own and those of its template arguments."""
    if not name.startswith("_Z"):
        return set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", name))
    names, i = set(), 2
    while i < len(name):
        m = re.match(r"[0-9]+", name[i:])
        if m is None:
            i += 1
            continue
        i += len(m.group())
        names.add(name[i : i + int(m.group())])
        i += int(m.group())
    return names


_KERNELS: list = []  # every Kernel made, for kernel_named
_FUNCTIONS: dict = {}  # CUfunction or CUkernel handle -> its Kernel, or None


def kernel_named(name: str):
    """The :class:`Kernel` whose device function ``name`` is (mangled or
    demangled), or None for a function of no kernel of the port."""
    names = source_names(name)
    for kernel in _KERNELS:
        if kernel.fn in names and (kernel.variant is None or kernel.variant in names):
            return kernel
    return None


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of cuda.h."""

    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x", "block_y", "block_z", "shared")
    ] + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern", "ctx")]


_libcuda = None


def _drv(fn: str, *args) -> None:
    """Call the CUDA driver's ``fn``; raise on an error."""
    global _libcuda
    if _libcuda is None:
        _libcuda = ctypes.CDLL("libcuda.so.1")
    err = getattr(_libcuda, fn)(*args)
    if err != 0:
        raise KernelError(f"{fn} failed with error {err}")


def _kernel_of_node(params: _KernelNodeParams):
    handle = params.func or params.kern
    if handle not in _FUNCTIONS:
        name = ctypes.c_char_p()
        if params.func:
            _drv("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            _drv("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
        _FUNCTIONS[handle] = kernel_named(name.value.decode())
    return _FUNCTIONS[handle]


def graph_kernel_nodes(graph) -> tuple:
    """``(nodes, {kernel: count})`` of a captured
    ``torch.cuda.CUDAGraph(keep_graph=True)``: its node count, and how many
    of its kernel nodes run each :class:`Kernel`'s device function (read
    with ``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams`` and
    ``cuFuncGetName``): the launches of the port's kernels that each replay
    of the graph makes."""
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _drv("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _drv("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    counts: dict = {}
    kind, params = ctypes.c_int(), _KernelNodeParams()
    for node in nodes:
        _drv("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        _drv("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(params))
        kernel = _kernel_of_node(params)
        if kernel is not None:
            counts[kernel] = counts.get(kernel, 0) + 1
    return n.value, counts


@contextlib.contextmanager
def recording_launches():
    """Record (and do not count) every launch until the block ends; for the
    capture of a CUDA graph, whose replays count them."""
    global _recording
    prev, log = _recording, LaunchLog()
    _recording = log
    try:
        yield log
    finally:
        _recording = prev


class KernelError(RuntimeError):
    pass


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA toolkit is required to build the kernels")
    return path


def _write_header(name: str, source: str, defines: dict) -> None:
    """``_build/<name>``: one ``#define`` per entry of ``defines`` (a list of
    values, or a list of rows), rewritten only when its text changes."""

    def arr(vals):
        if isinstance(vals[0], (list, tuple)):
            return "{" + ", ".join(arr(v) for v in vals) + "}"
        return "{" + ", ".join(f"0x{v:016x}ull" for v in vals) + "}"

    text = f"// Generated from {source} by utils/cuda.py.\n#pragma once\n" + "".join(
        f"#define {key} {arr(vals)}\n" for key, vals in defines.items()
    )
    path = BUILD_DIR / name
    if not path.exists() or path.read_text() != text:
        tmp = path.with_suffix(f".h.{os.getpid()}")
        tmp.write_text(text)
        os.replace(tmp, path)


def _write_generated_headers() -> None:
    """Headers derived from the Python protocol constants (one source of
    truth for the round constants of hash/constants.py and
    hash/rescue_constants.py)."""
    from ..field import gl
    from ..hash import constants as C
    from ..hash import rescue_constants as RC

    ext_rows = [C.ARK_EXT_INITIAL[12 * r : 12 * r + 12] for r in range(4)] + [
        C.ARK_EXT_TERMINAL[12 * r : 12 * r + 12] for r in range(4)
    ]
    _write_header("poseidon2_constants.h", "miden_tpu_torch/hash/constants.py", {
        "POSEIDON2_ARK_EXT": ext_rows,
        "POSEIDON2_ARK_INT": C.ARK_INT,
        "POSEIDON2_MAT_DIAG": C.MAT_DIAG,
    })
    # the kernels add round constants with gl::add, which takes canonical values
    assert all(v < gl.P for row in RC.ARK1 + RC.ARK2 for v in row)
    _write_header("rescue_constants.h", "miden_tpu_torch/hash/rescue_constants.py", {
        "RESCUE_ARK1": RC.ARK1,
        "RESCUE_ARK2": RC.ARK2,
        "RESCUE_MDS_ROW0": RC.MDS_ROW0,
    })


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not out.exists():
        return True
    newest = max(
        p.stat().st_mtime
        for p in [*CSRC.glob("*.cu"), *CSRC.glob("*.cuh"), *BUILD_DIR.glob("*.h")]
    )
    return out.stat().st_mtime < newest


def _start_build(name: str) -> tuple:
    out = _lib_path(name)
    tmp = out.with_suffix(f".so.{os.getpid()}")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-I", str(CSRC), "-I", str(BUILD_DIR),
        "-o", str(tmp), str(CSRC / f"{name}.cu"),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=None) -> float:
    """Build every (stale) kernel library, one nvcc per source in parallel.
    Returns the wall seconds taken."""
    names = list(names or sorted(p.stem for p in CSRC.glob("*.cu")))
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _write_generated_headers()
        jobs = [(n, *_start_build(n)) for n in names if _stale(n)]
        for name, proc, tmp, out in jobs:
            _finish_build(name, proc, tmp, out)
    return time.perf_counter() - t0


def load_built(names=None) -> None:
    """Load every kernel library that :func:`build_all` has built, raising if
    one is missing or stale: for processes that must not run nvcc (ranks
    spawned after their parent built, whose builds would race)."""
    names = list(names or sorted(p.stem for p in CSRC.glob("*.cu")))
    with _lock:
        for name in names:
            if _stale(name):
                raise KernelError(f"{_lib_path(name).name} is missing or stale: build it before starting ranks")
            _libs.setdefault(name, ctypes.CDLL(str(_lib_path(name))))


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib


def check_tensor(t: torch.Tensor, what: str, shape=None) -> None:
    """Device, dtype, shape and contiguity checks before a pointer crosses
    into a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != torch.int64:
        raise ValueError(f"{what}: expected int64, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


class Kernel:
    """One exported launcher of a kernel library, with its launch count and
    the count of launches per shape key (so that a run can time the kernel
    at the shapes it was really given)."""

    def __init__(self, lib: str, symbol: str, argtypes: list, fn: str, variant: str | None = None):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = argtypes
        self.fn = fn  # the __global__ function the launcher launches
        self.variant = variant  # the name of its template argument, where one tells it apart
        _KERNELS.append(self)
        self.launches = 0
        self.shapes: dict = {}
        self._fn = None

    def launch(self, *args, key=()) -> None:
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise KernelError(f"{self.symbol}: CUDA launch failed with error {err}")
        if _recording is not None:
            _recording.add(self, key)
        else:
            self.count(key)

    def count(self, key=(), n: int = 1) -> None:
        self.launches += n
        self.shapes[key] = self.shapes.get(key, 0) + n


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
U64 = ctypes.c_ulonglong
