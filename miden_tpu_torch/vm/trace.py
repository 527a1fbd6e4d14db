"""Execution trace builder: records the 51-column core trace during MAST
execution.

Behavioral spec: the decoder/stack trace semantics in
docs/src/design/decoder/index.md (block addressing, op-group decoding,
batch flags, END-row flags), docs/src/design/stack/index.md (depth b0,
overflow address b1, helper h0), and docs/src/design/range.md (the
2-column powers-of-3 range checker). The builder is a `Processor` tracer:
each processor row (one clk tick) appends one trace row capturing the
pre-op state; user-op helper registers are patched in post-op.

The produced matrix is the prover input: rows → AIR constraint evaluation
happens fully on device, this host builder is the trace-generating oracle
(SURVEY.md §2.4 — the reference keeps trace generation host-side too).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..field import gl
from . import layout as L
from .mast import BasicBlockNode, Program
from .ops import OPCODES

P = gl.P

HALT = OPCODES["HALT"]
SPAN = OPCODES["SPAN"]
RESPAN = OPCODES["RESPAN"]
END = OPCODES["END"]
REPEAT = OPCODES["REPEAT"]
JOIN = OPCODES["JOIN"]
SPLIT = OPCODES["SPLIT"]
LOOP = OPCODES["LOOP"]
CALL = OPCODES["CALL"]
SYSCALL = OPCODES["SYSCALL"]
DYN = OPCODES["DYN"]
DYNCALL = OPCODES["DYNCALL"]

# powers-of-3 step sizes allowed between consecutive range-checker values
# (docs/src/design/range.md: Δv ∈ {0, 1, 3, 9, ..., 2187})
RANGE_STEPS = [3**k for k in range(7, -1, -1)]


@dataclass
class SpanState:
    """Decode state while inside a basic block."""

    node: BasicBlockNode
    addr: int  # current batch address (advances by 2 per RESPAN)
    parent: int
    gc: int  # groups not yet started/consumed
    queue: list[int]  # unstarted groups of the current batch, in order
    pending_group: int | None  # group the next op starts
    rem: int = 0  # current group with executed ops removed
    op_index: int = 0


@dataclass
class CoreTrace:
    """The finalized core trace, the chiplets trace, and the replay logs
    they were built from."""

    matrix: np.ndarray  # (n, 51) uint64
    chiplets: np.ndarray  # (m, 24) uint64 (ChipletsVmAir.width)
    poseidon: np.ndarray  # (16k, 16) uint64
    num_real_rows: int
    program_hash: tuple
    stack_inputs: list[int]
    stack_outputs: list[int]
    kernel_digests: tuple = ()
    deferred_root: tuple = (0, 0, 0, 0)
    hasher_requests: list = field(default_factory=list)
    mem_log: list = field(default_factory=list)
    bitwise_log: list = field(default_factory=list)
    kernel_log: list = field(default_factory=list)
    range_values: list = field(default_factory=list)  # requested 16-bit values


def _batch_flags(num_groups: int) -> tuple:
    return L.BATCH_FLAGS_BY_COUNT[num_groups]


class TraceBuilder:
    """Processor tracer that materializes the core execution trace."""

    def __init__(self) -> None:
        self.proc = None
        self.rows: list[list[int]] = []
        # native-traced row blocks: (python-row index they precede, array)
        self.segments: list[tuple[int, np.ndarray]] = []
        self._seg_rows = 0
        self.addr_stack: list = []  # SpanState | int (control-block addr)
        self.program_hash: tuple = (0, 0, 0, 0)
        self.stack_inputs: list[int] = []
        self._halted = False

    @property
    def n_rows(self) -> int:
        """Virtual row count: python rows + native segment rows."""
        return len(self.rows) + self._seg_rows

    def append_segment(self, arr: np.ndarray) -> None:
        """Splice a block of rows produced by the C interpreter (one whole
        basic block: SPAN + ops + RESPANs + END) at the current position."""
        assert arr.ndim == 2 and arr.shape[1] == L.CORE_WIDTH
        self.segments.append((len(self.rows), arr))
        self._seg_rows += arr.shape[0]

    # -- wiring -------------------------------------------------------------

    def attach(self, proc) -> None:
        self.proc = proc
        self.stack_inputs = list(proc.stack[: L.MIN_STACK_DEPTH])

    def _cur_addr(self) -> int:
        if not self.addr_stack:
            return 0
        top = self.addr_stack[-1]
        return top.addr if isinstance(top, SpanState) else top

    def _span(self) -> SpanState:
        top = self.addr_stack[-1]
        assert isinstance(top, SpanState), "not inside a basic block"
        return top

    # -- row capture --------------------------------------------------------

    def _capture(
        self,
        opcode: int,
        addr: int,
        h=(0,) * 8,
        in_span: int = 0,
        gc: int = 0,
        op_index: int = 0,
        batch=(0, 0, 0),
    ) -> list[int]:
        p = self.proc
        bits = [(opcode >> i) & 1 for i in range(7)]
        e0 = bits[6] & (1 - bits[5]) & bits[4]
        e1 = bits[6] & bits[5]
        row = [
            p.clk,
            p.ctx,
            *p.fn_hash,
            addr,
            *bits,
            *h,
            in_span,
            gc,
            op_index,
            *batch,
            e0,
            e1,
            *p.stack[: L.MIN_STACK_DEPTH],
            p.depth,
            p.overflow_addr,
            0,  # stack helper h0 = 1/(b0-16), batch-filled in finalize
            0,  # rc multiplicity
            0,  # rc value
        ]
        assert len(row) == L.CORE_WIDTH
        assert p.clk == self.n_rows, "one trace row per clk tick"
        self.rows.append(row)
        return row

    # -- control-flow hooks (processor tracer interface) ---------------------

    def on_join_start(self, node, addr: int) -> None:
        forest = self.proc.forest
        left = forest[node.children[0]].digest
        right = forest[node.children[1]].digest
        self._capture(JOIN, self._cur_addr(), h=(*left, *right))
        self.addr_stack.append(addr)

    def on_split_start(self, node, addr: int) -> None:
        forest = self.proc.forest
        on_true = forest[node.children[0]].digest
        on_false = forest[node.children[1]].digest
        self._capture(SPLIT, self._cur_addr(), h=(*on_true, *on_false))
        self.addr_stack.append(addr)

    def on_loop_start(self, node, addr: int) -> None:
        body = self.proc.forest[node.children[0]].digest
        self._capture(LOOP, self._cur_addr(), h=(*body, 0, 0, 0, 0))
        self.addr_stack.append(addr)

    def on_repeat(self, node) -> None:
        # h0..h4 are copied from the loop body's END row
        # (decoder/constraints.md: f_end * f_repeat' * (h_i' - h_i) = 0)
        body = self.proc.forest[node.children[0]].digest
        self._capture(REPEAT, self._cur_addr(), h=(*body, 1, 0, 0, 0))

    def on_call_start(self, node, callee_digest, addr: int) -> None:
        opcode = SYSCALL if node.is_syscall else CALL
        self._capture(opcode, self._cur_addr(), h=(*callee_digest, 0, 0, 0, 0))
        self.addr_stack.append(addr)

    def on_dyn_start(self, node, callee_digest, addr: int) -> None:
        p = self.proc
        if node.is_dyncall:
            # h4/h5 = post-shift depth and overflow address — what the END
            # restore validates via the block stack table
            # (decoder/constraints.md v_dyncall)
            depth = p.depth - 1 if p.depth > L.MIN_STACK_DEPTH else L.MIN_STACK_DEPTH
            ovf = p.overflow_addrs[1] if len(p.overflow_addrs) > 1 else 0
            h = (*callee_digest, depth, ovf, 0, 0)
            self._capture(DYNCALL, self._cur_addr(), h=h)
        else:
            self._capture(DYN, self._cur_addr(), h=(*callee_digest, 0, 0, 0, 0))
        self.addr_stack.append(addr)

    def on_node_end(self, digest, is_loop_body, is_loop, is_call, is_syscall) -> None:
        top = self.addr_stack[-1]
        if isinstance(top, SpanState):
            assert top.gc == 0, "END with unconsumed op groups"
            assert top.rem == 0 and not top.queue
            addr = top.addr
        else:
            addr = top
        h = (*digest, int(is_loop_body), int(is_loop), int(is_call), int(is_syscall))
        self._capture(END, addr, h=h)
        self.addr_stack.pop()

    # -- basic-block hooks ---------------------------------------------------

    def on_span_start(self, node, addr: int) -> None:
        batch0 = node.batches[0]
        total = sum(b.num_groups for b in node.batches)
        self._capture(
            SPAN,
            self._cur_addr(),
            h=tuple(batch0.groups),
            gc=total,
            batch=_batch_flags(batch0.num_groups),
        )
        self.addr_stack.append(
            SpanState(
                node=node,
                addr=addr,
                parent=self._pre_span_parent(),
                gc=total - 1,
                queue=list(batch0.groups[1 : batch0.num_groups]),
                pending_group=batch0.groups[0],
            )
        )

    def _pre_span_parent(self) -> int:
        return self._cur_addr()

    def on_respan(self, node, batch_index: int) -> None:
        st = self._span()
        assert st.rem == 0 and not st.queue, "RESPAN before batch exhausted"
        batch = node.batches[batch_index]
        self._capture(
            RESPAN,
            st.addr,
            h=tuple(batch.groups),
            gc=st.gc,
            batch=_batch_flags(batch.num_groups),
        )
        st.addr += 2
        st.gc -= 1
        st.queue = list(batch.groups[1 : batch.num_groups])
        st.pending_group = batch.groups[0]

    def pre_op(self, op, op_idx_in_group: int) -> None:
        st = self._span()
        code = op.op_code
        if st.pending_group is not None:
            st.rem = (st.pending_group - code) >> 7
            st.pending_group = None
            st.op_index = 0
        else:
            assert st.rem & 0x7F == code, (
                f"op {op.name} does not match group stream (rem={st.rem:#x})"
            )
            st.rem >>= 7
            st.op_index += 1
        assert st.op_index == op_idx_in_group, "op index drift vs processor"
        # h1 on every user-op row carries the parent block address
        # (reference: trace/parallel/tracer/trace_row.rs:99-118 new_operation)
        self._capture(
            code,
            st.addr,
            h=(st.rem, st.parent, 0, 0, 0, 0, 0, 0),
            in_span=1,
            gc=st.gc,
            op_index=st.op_index,
        )
        # row-level group consumption (reflected in the NEXT row's gc):
        if op.imm is not None:
            imm_group = st.queue.pop(0)
            assert imm_group == op.imm, "immediate does not match batch group"
            st.gc -= 1
            # rem == 0 here is legal: the batcher guarantees the next op in
            # this group is the padding NOOP the decoding constraint forces
            # (docs decoder/constraints.md §group count)
        elif st.rem == 0 and st.queue:
            st.pending_group = st.queue.pop(0)
            st.gc -= 1

    def post_op(self, op, helpers) -> None:
        row = self.rows[-1]
        for i, v in enumerate(helpers[:6]):
            row[L.USER_OP_HELPERS[i]] = v % P

    def on_halt(self) -> None:
        from .processor import ExecutionError

        self._halted = True
        assert not self.addr_stack, "halt with open blocks"
        if self.proc.depth != L.MIN_STACK_DEPTH:
            # the b0 = 16 last-row boundary constraint makes this unprovable
            # (docs stack/index.md §boundary constraints)
            raise ExecutionError(
                f"program must end with stack depth 16, got {self.proc.depth}"
            )

    # -- finalize ------------------------------------------------------------

    def _assemble_real_rows(self) -> np.ndarray:
        """Merge python rows and native segments in emission order."""
        py = np.asarray(self.rows, dtype=np.uint64).reshape(
            len(self.rows), L.CORE_WIDTH
        )
        if not self.segments:
            return py
        blocks = []
        prev = 0
        for pos, arr in self.segments:  # positions are non-decreasing
            if pos > prev:
                blocks.append(py[prev:pos])
                prev = pos
            blocks.append(arr)
        if prev < len(py):
            blocks.append(py[prev:])
        return np.concatenate(blocks, axis=0)

    def finalize(self, program: Program) -> CoreTrace:
        assert self._halted, "finalize before halt"
        p = self.proc
        self.program_hash = program.forest[program.entrypoint].digest
        real = self._assemble_real_rows()
        n_real = real.shape[0]
        assert n_real == self.n_rows

        # chiplets trace (memory + bitwise regions); its 16-bit delta limbs
        # are range-checked through the core range column
        from . import chiplets as CH

        chiplets, poseidon, mem_range = CH.build_chiplets_trace(
            p.hasher.requests,
            p.bitwise_log,
            p.mem_log,
            program.kernel_digests,
            p.kernel_log,
            p.ace_log,
        )

        # 16-bit range-check requests: every u32rc-flagged row (opcode prefix
        # 0b100) requests its four helper limbs h2..h5 (docs range.md bus),
        # plus the memory chiplet's d0/d1 limbs. Vectorized over the whole
        # matrix (the per-row python loop was O(n) on multi-100k-row traces).
        requests: list[int] = list(mem_range)
        opcodes = np.zeros(n_real, dtype=np.uint64)
        for i in range(7):
            opcodes |= real[:, L.OP_BITS[i]] << np.uint64(i)
        u32rc = (opcodes >> np.uint64(4)) == np.uint64(0b100)
        if u32rc.any():
            helper_cols = [L.HASHER[2], L.HASHER[3], L.HASHER[4], L.HASHER[5]]
            requests.extend(int(v) for v in real[u32rc][:, helper_cols].reshape(-1))
        rc_rows = _range_checker_rows(requests)

        # Core height = pad(max(core rows incl. one HALT row, range table))
        # (reference trace/parallel/mod.rs:170 core_height; the range table
        # already carries its trailing extra 65535 row)
        target = max(n_real + 1, L.MIN_TRACE_LEN, len(rc_rows))
        n = 1 << (target - 1).bit_length()

        # HALT padding: program hash carried in h0..h3, stack copied forward,
        # clk keeps incrementing (decoder/index.md §HALT) — one vectorized
        # template fill instead of a per-row python loop.
        stack_out = list(p.stack[: L.MIN_STACK_DEPTH])
        bits = [(HALT >> i) & 1 for i in range(7)]
        pad_template = [
            0,
            p.ctx,
            *p.fn_hash,
            0,
            *bits,
            *self.program_hash,
            0, 0, 0, 0,
            0, 0, 0,
            0, 0, 0,
            bits[6] & (1 - bits[5]) & bits[4],
            bits[6] & bits[5],
            *stack_out,
            p.depth,
            p.overflow_addr,
            0, 0, 0,
        ]
        assert len(pad_template) == L.CORE_WIDTH

        m = np.zeros((n, L.CORE_WIDTH), dtype=np.uint64)
        m[:n_real] = real
        m[n_real:] = np.asarray(pad_template, dtype=np.uint64)
        m[n_real:, L.CLK] = np.arange(n_real, n, dtype=np.uint64)

        # stack helper h0 = 1/(b0 - 16), 0 at depth 16 — depths are small and
        # few, so invert the distinct values once and scatter through a LUT
        depths = m[:, L.B0].astype(np.int64) - 16
        uniq = np.unique(depths)
        lut = np.zeros(int(uniq.max()) + 1 if uniq.size else 1, dtype=np.uint64)
        for d in uniq:
            d = int(d)
            lut[d] = pow(d, P - 2, P) if d else 0
        m[:, L.H0] = lut[depths]

        # range checker columns: bottom-aligned — all-zero padding rows
        # first, then values 0→65535 with powers-of-3 bridges and a trailing
        # (0, 65535) row on the last trace row (reference
        # trace/range/mod.rs:82 write_range_into_core: table start offset =
        # core_height − range_table_len)
        vals = np.zeros(n, dtype=np.uint64)
        mults = np.zeros(n, dtype=np.uint64)
        pad = n - len(rc_rows)
        for i, (v, mult) in enumerate(rc_rows):
            vals[pad + i] = v
            mults[pad + i] = mult
        m[:, L.RC_VALUE] = vals
        m[:, L.RC_MULT] = mults

        return CoreTrace(
            matrix=m,
            chiplets=chiplets,
            poseidon=poseidon,
            num_real_rows=n_real,
            program_hash=self.program_hash,
            stack_inputs=self.stack_inputs,
            stack_outputs=stack_out,
            kernel_digests=tuple(program.kernel_digests),
            deferred_root=tuple(p.deferred_root),
            hasher_requests=list(p.hasher.requests),
            mem_log=list(getattr(p, "mem_log", [])),
            bitwise_log=list(getattr(p, "bitwise_log", [])),
            kernel_log=list(getattr(p, "kernel_log", [])),
            range_values=requests,
        )


def _range_checker_rows(requests: list[int]) -> list[tuple[int, int]]:
    """(value, multiplicity) rows: sorted distinct requested values plus
    bridge rows so consecutive deltas are powers of 3 ≤ 3^7, anchored at 0
    and 65535, plus one trailing (65535, 0) row reserving b_range headroom
    (reference trace/range/mod.rs:106 emit_table_rows — exact emission
    order replicated)."""
    counts: dict[int, int] = {}
    for v in requests:
        assert 0 <= v < 65536, f"range request {v} out of u16"
        counts[v] = counts.get(v, 0) + 1
    anchors = sorted(set(counts) | {0, 65535})
    rows: list[tuple[int, int]] = []
    prev = 0
    for v in anchors:
        gap = v - prev
        at = prev
        stride = 3**7
        while gap != stride:
            if gap > stride:
                gap -= stride
                at += stride
                rows.append((at, 0))
            else:
                stride //= 3
        rows.append((v, counts.get(v, 0)))
        prev = v
    rows.append((65535, 0))
    return rows


def execute_and_trace(program: Program, stack_inputs=None, advice=None, **opts):
    """Execute a program and build its core trace.

    Mirrors `execute_trace_inputs_sync` + `build_trace`
    (processor/src/fast/execution_api.rs:161, trace/parallel/mod.rs:91).
    Returns (ExecutionOutput, CoreTrace).

    The Python interpreter walks the control flow; each basic block inside
    the native op subset executes and traces in C (~10^8 rows/s,
    miden_tpu_torch/native/trace_gen.c, via ``native_block_segment``), and a
    block with an unsupported op (:class:`NativeUnsupported`) runs in the
    exact Python interpreter. A C library that fails to build or load raises
    (``NativeBuildError``) instead of falling through to the interpreter.
    """
    from .processor import Processor, StackInputs

    if isinstance(stack_inputs, list):
        stack_inputs = StackInputs(stack_inputs)
    tracer = TraceBuilder()
    proc = Processor(program, stack_inputs, advice, tracer=tracer, **opts)
    out = proc.execute()
    return out, tracer.finalize(program)
