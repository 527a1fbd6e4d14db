"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``_build/lib<name>.so``), loaded with
``ctypes``. Libraries are built at first use, or all at once (one ``nvcc``
per source, run in parallel) by :func:`build_all`. Nothing is built or
loaded when a module is imported.

Every exported launcher takes the pointers and the stream as ``void*`` and
returns the CUDA error of its launch; :meth:`Kernel.launch` raises when it is
not 0 and otherwise adds one to the kernel's ``launches`` count.
"""

from __future__ import annotations

import ctypes
import os
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

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = argtypes
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
        self.launches += 1
        self.shapes[key] = self.shapes.get(key, 0) + 1


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
