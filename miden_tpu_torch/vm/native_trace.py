"""Native-path trace generation: basic blocks executed and traced in C.

The scalable front-end for real-program proving (reference analog: the
320 MHz FastProcessor + rayon build_trace, processor/src/fast/mod.rs:102,
trace/parallel/mod.rs:91). The Python interpreter walks a program's
control flow; each basic block over the supported op subset executes in C
at ~10^8 rows/s with its trace rows written straight into a numpy buffer.
A block with an op outside the subset (:class:`NativeUnsupported`) runs in
the exact, slow Python interpreter instead.

``RUNS`` counts the basic blocks executed in C (``"block"``) and the
core-trace rows they wrote (``"rows"``), so that a run can show which path
built its trace. Equality with ``miden_tpu``'s traces is pinned by
tests/test_torch_vm_host.py.
"""

from __future__ import annotations

import numpy as np

from ..field import gl
from . import layout as L
from .mast import BasicBlockNode

P = gl.P

RUNS = {"block": 0, "rows": 0}

# internal dispatch kinds — must match the enum in native/trace_gen.c
_KINDS = {
    "NOOP": 0, "ASSERT": 1, "ADD": 2, "MUL": 3, "NEG": 4, "INV": 5,
    "INCR": 6, "NOT": 7, "AND": 8, "OR": 9, "EQ": 10, "EQZ": 11,
    "EXPACC": 12, "EXT2MUL": 13, "PAD": 14, "DROP": 15, "SWAP": 16,
    "SWAPW": (17, 4), "SWAPW2": (17, 8), "SWAPW3": (17, 12), "SWAPDW": 18,
    "CSWAP": 22, "CSWAPW": 23, "PUSH": 24, "SDEPTH": 25, "CLK": 26,
    "U32SPLIT": 27, "U32ADD": 28, "U32ADD3": 29, "U32SUB": 30,
    "U32MUL": 31, "U32MADD": 32, "U32DIV": 33, "U32ASSERT2": 34,
}
for _i in range(16):
    _KINDS[f"DUP{_i}"] = (19, _i)
for _i in range(2, 9):
    _KINDS[f"MOVUP{_i}"] = (20, _i)
    _KINDS[f"MOVDN{_i}"] = (21, _i)


class NativeUnsupported(Exception):
    pass


def _op_tables(node: BasicBlockNode):
    n_batches = len(node.batches)
    groups = np.zeros(n_batches * 8, dtype=np.uint64)
    n_groups = np.zeros(n_batches, dtype=np.int64)
    batch_of_op, codes, kinds, params, imms, has_imm = [], [], [], [], [], []
    for bi, batch in enumerate(node.batches):
        groups[bi * 8 : bi * 8 + 8] = [g % P for g in batch.groups]
        n_groups[bi] = batch.num_groups
        for op in batch.ops:
            k = _KINDS.get(op.name)
            if k is None:
                raise NativeUnsupported(op.name)
            kind, param = k if isinstance(k, tuple) else (k, 0)
            batch_of_op.append(bi)
            codes.append(op.op_code)
            kinds.append(kind)
            params.append(param)
            imms.append(op.imm or 0)
            has_imm.append(1 if op.imm is not None else 0)
    return (
        groups,
        n_groups,
        np.asarray(batch_of_op, dtype=np.int64),
        np.asarray(codes, dtype=np.uint64),
        np.asarray(kinds, dtype=np.int64),
        np.asarray(params, dtype=np.uint64),
        np.asarray(imms, dtype=np.uint64),
        np.asarray(has_imm, dtype=np.uint64),
    )


def _node_tables(node: BasicBlockNode):
    cache = node.__dict__.get("_native_tables")
    if cache is None:
        cache = _op_tables(node)
        node.__dict__["_native_tables"] = cache
    return cache


def native_block_segment(
    proc, tracer, node: BasicBlockNode, addr: int, is_loop_body: bool = False
) -> bool:
    """Execute + trace one basic block in C at the processor's current
    state, splicing the rows (SPAN + ops + RESPANs + END) into the tracer
    as a segment and advancing the processor (clk, stack, overflow).

    Returns False (leaving all state untouched) when the block is outside
    the native op subset — the caller then runs the exact Python path.
    The hybrid keeps control flow (join/split/loop/call rows, memory and
    chiplet ops) in Python at O(#nodes) cost while the op rows — the bulk
    of any long trace — are written at C speed (reference analog: the
    fragment-parallel ReplayProcessor, processor/src/trace/parallel/).
    """
    import ctypes

    if tracer is None or not hasattr(tracer, "append_segment"):
        return False
    try:
        tables = _node_tables(node)
    except NativeUnsupported:
        return False
    from ..native import trace_gen_lib

    groups, n_groups, batch_of_op, codes, kinds, params, imms, has_imm = tables
    n_ops = len(codes)
    n_batches = len(n_groups)
    n_rows = n_ops + n_batches + 1  # SPAN + ops + RESPANs + END

    depth0 = proc.depth
    stack_init = np.zeros(depth0, dtype=np.uint64)
    stack_init[: len(proc.stack)] = [v % P for v in proc.stack[:depth0]]
    ovf_init = np.asarray(proc.overflow_addrs, dtype=np.uint64)
    fn_hash = np.asarray(proc.fn_hash, dtype=np.uint64)
    digest = np.asarray(node.digest, dtype=np.uint64)

    out = np.zeros((n_rows, L.CORE_WIDTH), dtype=np.uint64)
    rc_out = np.zeros(max(4 * n_ops, 4), dtype=np.uint64)
    stack_cap = depth0 + 32 + n_ops
    stack_buf = np.zeros(stack_cap, dtype=np.uint64)
    ovf_buf = np.zeros(stack_cap, dtype=np.uint64)
    final16 = np.zeros(16, dtype=np.uint64)
    final_ovf = np.zeros(stack_cap, dtype=np.uint64)
    final_ovf_clk = np.zeros(stack_cap, dtype=np.uint64)
    n_rc = np.zeros(1, dtype=np.int64)
    final_depth = np.zeros(1, dtype=np.int64)
    final_clk = np.zeros(1, dtype=np.uint64)

    lib = trace_gen_lib()
    u64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    i64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rows = lib.run_block_segment(
        u64p(groups), i64p(n_groups), n_batches,
        i64p(batch_of_op), u64p(codes), i64p(kinds),
        u64p(params), u64p(imms), u64p(has_imm), n_ops,
        u64p(stack_init), depth0, u64p(ovf_init),
        proc.clk, proc.ctx, u64p(fn_hash),
        addr, tracer._cur_addr(), 1, int(is_loop_body), u64p(digest),
        u64p(out), n_rows, u64p(rc_out), i64p(n_rc),
        u64p(stack_buf), u64p(ovf_buf), stack_cap,
        u64p(final16), u64p(final_ovf), u64p(final_ovf_clk),
        i64p(final_depth), u64p(final_clk),
    )
    if rows < 0:
        from .processor import ExecutionError

        raise ExecutionError(f"native block execution failed (code {rows})")
    assert int(rows) == n_rows

    tracer.append_segment(out)
    RUNS["block"] += 1
    RUNS["rows"] += n_rows
    depth = int(final_depth[0])
    n_ovf = depth - L.MIN_STACK_DEPTH
    proc.stack = [int(v) for v in final16] + [
        int(v) for v in final_ovf[:n_ovf]
    ]
    proc.overflow_addrs = [int(v) for v in final_ovf_clk[:n_ovf]]
    proc.depth = depth
    proc.clk = int(final_clk[0])
    return True
