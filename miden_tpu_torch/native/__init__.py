"""Native (C) host runtime: the basic-block interpreter and trace emitter.

The host-side runtime pieces the reference implements in Rust (fast
interpreter + trace builder, processor/src/fast/ + trace/parallel/) are C
here (``trace_gen.c``). The library is compiled with the host C compiler
(``$CC``, default ``cc``) at first use into the git-ignored
``miden_tpu_torch/_build/`` beside the CUDA kernel libraries, and rebuilt
when the source is newer. Nothing is built or loaded at import.

A failed build or load raises :class:`NativeBuildError`: the port never
falls back to the Python interpreter for a program the C path supports
(that interpreter runs about 10^5 rows/s, hours at 2^18 rows).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

from ..utils.cuda import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "trace_gen.c"
LIBRARY = BUILD_DIR / "libtrace_gen.so"

_lock = threading.Lock()
_LIB = None


class NativeBuildError(RuntimeError):
    pass


def _build() -> Path:
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".so.{os.getpid()}")
    cc = os.environ.get("CC", "cc")
    try:
        proc = subprocess.run(
            [cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise NativeBuildError(f"cannot run the C compiler {cc!r}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"{cc} failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)  # atomic: concurrent builders leave one whole file
    return LIBRARY


def trace_gen_lib():
    """The compiled trace-generator library (built at first use, cached)."""
    global _LIB
    with _lock:
        if _LIB is None:
            try:
                lib = ctypes.CDLL(str(_build()))
            except OSError as e:
                raise NativeBuildError(f"cannot load {LIBRARY}: {e}") from e
            _declare(lib)
            _LIB = lib
    return _LIB


def _declare(lib) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.run_block_segment.restype = ctypes.c_int64
    lib.run_block_segment.argtypes = [
        u64p, i64p, ctypes.c_int64,           # groups, n_groups, n_batches
        i64p, u64p, i64p,                     # batch_of_op, op_code, op_kind
        u64p, u64p, u64p,                     # op_param, op_imm, op_has_imm
        ctypes.c_int64,                       # n_ops
        u64p, ctypes.c_int64, u64p,           # stack_init, depth0, ovf_clk_init
        ctypes.c_uint64, ctypes.c_uint64, u64p,  # clk0, ctx, fn_hash
        ctypes.c_uint64, ctypes.c_uint64,     # block_addr, parent_addr
        ctypes.c_int64, ctypes.c_int64, u64p,  # write_end, is_loop_body, digest
        u64p, ctypes.c_int64, u64p, i64p,     # out, cap_rows, rc_out, n_rc_out
        u64p, u64p, ctypes.c_int64,           # stack_buf, ovf_buf, stack_cap
        u64p, u64p, u64p, i64p, u64p,         # final 16/ovf/ovf_clk/depth/clk
    ]
    lib.p2_set_constants.restype = None
    lib.p2_set_constants.argtypes = [u64p, u64p, u64p, u64p]
    lib.p2_permute_batch.restype = None
    lib.p2_permute_batch.argtypes = [u64p, ctypes.c_int64]
    lib.p2_chain_basic_block.restype = None
    lib.p2_chain_basic_block.argtypes = [u64p, ctypes.c_int64, u64p, u64p]
    lib.p2_packed_rows.restype = None
    lib.p2_packed_rows.argtypes = [u64p, ctypes.c_int64, u64p, u64p]

    import numpy as np

    from ..hash import constants as C

    tables = [
        np.asarray(t, dtype=np.uint64)
        for t in (C.ARK_EXT_INITIAL, C.ARK_INT, C.ARK_EXT_TERMINAL, C.MAT_DIAG)
    ]
    lib.p2_set_constants(*(u64ptr(t) for t in tables))


def u64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
