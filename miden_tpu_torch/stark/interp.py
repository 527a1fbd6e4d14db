"""The bytecode constraint evaluator: ``Air.eval`` recorded once as a flat
base-field SSA program, run over every point of a quotient coset.

:class:`RecordBackend` runs an AIR's ``eval`` through the scalar folder and
records every Goldilocks ADD/SUB/MUL it would perform as an instruction
over register ids; :func:`_collect_constants` is the dry pass that finds
every integer constant ``eval`` uses, so they can be interned first. The
ACE codegen (``vm/ace_codegen.py``) lowers the recording to the VM's
arithmetic-circuit format, whose Poseidon2 commitments seed the VM's
Fiat–Shamir challenger (``vm/ace_registry.py``).

:class:`ConstraintProgram` register-allocates the recording (a linear scan
that reuses freed frame slots), with the input layout and allocator of
``miden_tpu.stark.interp`` so that its code is equal instruction for
instruction. :func:`evaluate_folded_constraints` runs it over a quotient
coset: on CUDA tensors as kernel Q1 (``csrc/constraints.cu``), which runs
the program's :class:`Schedule` (:func:`make_schedule`: the same
instructions reordered, its frame mostly in shared memory), on CPU tensors
as the plain twin :func:`run_program_plain`, a Python loop over the
recorded instructions. The prover sends the VM AIRs (``prefer_interp``) and every
quotient domain of 2^21 points or more here, as ``miden_tpu`` does
(``stark/prover.py`` :func:`~.prover.uses_program`). The very same
``Air.eval`` is recorded, so the α-fold order and every constraint value
equal the eager evaluator's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..field import gl
from ..field import goldilocks as F
from ..utils import cuda
from .air import Air, Expr, Folder, ScalarBackend

OP_ADD, OP_SUB, OP_MUL = 0, 1, 2


class RecordBackend(ScalarBackend):
    """Records base-field SSA instructions; values are register ids.

    Extension-field values are (lo_reg, hi_reg) tuples; ext arithmetic
    decomposes into base instructions exactly like gl.ext_* (x² = 7).
    Constants must be interned (``intern``) before recording starts.
    """

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.instrs: list[tuple[int, int, int]] = []
        self.consts: dict[int, int] = {}
        self.const_values: list[int] = []
        self._sealed = False

    def intern(self, c: int) -> int:
        c %= gl.P
        reg = self.consts.get(c)
        if reg is None:
            assert not self._sealed, f"constant {c} discovered after sealing"
            reg = self.n_inputs + len(self.const_values)
            self.consts[c] = reg
            self.const_values.append(c)
        return reg

    def seal(self) -> None:
        self._sealed = True
        self.n_fixed = self.n_inputs + len(self.const_values)

    def _emit(self, op: int, a: int, b: int) -> int:
        self.instrs.append((op, a, b))
        return self.n_fixed + len(self.instrs) - 1

    def const(self, c: int):
        return self.intern(c)

    def _scal(self, f, a, b):
        if isinstance(a, list) or isinstance(b, list):
            if not isinstance(a, list):
                a = [a] * len(b)
            if not isinstance(b, list):
                b = [b] * len(a)
            return [f(x, y) for x, y in zip(a, b)]
        return f(a, b)

    def add(self, a, b, ka, kb):
        if ka == "base" and kb == "base":
            return self._scal(lambda x, y: self._emit(OP_ADD, x, y), a, b)
        return self._scal(self._ext_add, self._ext(a, ka), self._ext(b, kb))

    def sub(self, a, b, ka, kb):
        if ka == "base" and kb == "base":
            return self._scal(lambda x, y: self._emit(OP_SUB, x, y), a, b)
        return self._scal(self._ext_sub, self._ext(a, ka), self._ext(b, kb))

    def mul(self, a, b, ka, kb):
        if ka == "base" and kb == "base":
            return self._scal(lambda x, y: self._emit(OP_MUL, x, y), a, b)
        if ka == "base":
            return self._scal(lambda y, x: self._ext_mul_base(y, x), b, a)
        if kb == "base":
            return self._scal(self._ext_mul_base, a, b)
        return self._scal(self._ext_mul, a, b)

    def mul_int(self, v, c: int, kind: str):
        creg = self.intern(c)
        if kind == "base":
            if isinstance(v, list):
                return [self._emit(OP_MUL, x, creg) for x in v]
            return self._emit(OP_MUL, v, creg)
        if isinstance(v, list):
            return [self._ext_mul_base(x, creg) for x in v]
        return self._ext_mul_base(v, creg)

    def _ext(self, v, k):
        if k == "ext":
            return v
        zero = self.intern(0)
        if isinstance(v, list):
            return [(x, zero) for x in v]
        return (v, zero)

    def _ext_add(self, a, b):
        return (self._emit(OP_ADD, a[0], b[0]), self._emit(OP_ADD, a[1], b[1]))

    def _ext_sub(self, a, b):
        return (self._emit(OP_SUB, a[0], b[0]), self._emit(OP_SUB, a[1], b[1]))

    def _ext_mul_base(self, a, s):
        return (self._emit(OP_MUL, a[0], s), self._emit(OP_MUL, a[1], s))

    def _ext_mul(self, a, b):
        a0b0 = self._emit(OP_MUL, a[0], b[0])
        a1b1 = self._emit(OP_MUL, a[1], b[1])
        a0b1 = self._emit(OP_MUL, a[0], b[1])
        a1b0 = self._emit(OP_MUL, a[1], b[0])
        t = self._emit(OP_MUL, a1b1, self.intern(7))
        return (self._emit(OP_ADD, a0b0, t), self._emit(OP_ADD, a0b1, a1b0))


def _collect_constants(air: Air, n_pub: int, n_rand: int, n_auxv: int) -> list[int]:
    """Dry scalar pass observing every integer constant eval() uses."""
    seen: list[int] = []

    class _Catch(ScalarBackend):
        def const(self, c):
            seen.append(c % gl.P)
            return super().const(c)

        def mul_int(self, v, c, kind):
            seen.append(c % gl.P)
            return super().mul_int(v, c, kind)

    be = _Catch()
    one = Expr(be, "base", 1)
    f = Folder(
        be,
        main_fn=lambda c, o=0: Expr(be, "base", 1),
        aux_fn=lambda c, o=0: Expr(be, "ext", (1, 0)),
        preprocessed_fn=lambda c, o=0: Expr(be, "base", 1),
        periodic=[Expr(be, "base", 1) for _ in air.periodic_columns],
        publics=[Expr(be, "base", 0)] * n_pub,
        randomness=[Expr(be, "ext", (1, 1))] * n_rand,
        aux_values=[Expr(be, "ext", (1, 1))] * n_auxv,
        selectors=(one, one, one),
        alpha=Expr(be, "ext", (1, 1)),
    )
    air.eval(f)
    return seen


class ConstraintProgram:
    """A recorded, register-allocated constraint program for one Air.

    Input register layout (order matched by :func:`evaluate_folded_constraints`),
    split into a per-point VECTOR block and a point-independent SCALAR block
    so that the executor never broadcasts scalars (publics / randomness /
    constants) to the whole domain:
      vector [0, n_vec):  main cur (w) | main next (w) | pp cur (pw) |
                          pp next (pw) | aux cur (2aw) | aux next (2aw) |
                          selectors (3) | periodic (p)
      scalar [n_vec, n_fixed): publics | randomness (2 each) |
                          aux_values (2 each) | alpha (2) | constants
    Registers from ``n_fixed`` on are frame slots; ``code`` rows are
    ``(op, a, b, dst)``.
    """

    def __init__(self, air: Air, n_pub: int, n_rand: int, n_auxv: int):
        self.air = air
        w, aw, p = air.width, air.aux_width, len(air.periodic_columns)
        pw = air.preprocessed_width
        self.n_pub, self.n_rand, self.n_auxv = n_pub, n_rand, n_auxv
        self.n_vec = 2 * w + 2 * pw + 4 * aw + 3 + p
        n_inputs = self.n_vec + n_pub + 2 * n_rand + 2 * n_auxv + 2

        be = RecordBackend(n_inputs)
        for c in [0, 1, 7] + _collect_constants(air, n_pub, n_rand, n_auxv):
            be.intern(c)
        be.seal()

        nxt = iter(range(n_inputs)).__next__
        main_cur = [nxt() for _ in range(w)]
        main_next = [nxt() for _ in range(w)]
        pp_cur = [nxt() for _ in range(pw)]
        pp_next = [nxt() for _ in range(pw)]
        aux_cur = [(nxt(), nxt()) for _ in range(aw)]
        aux_next = [(nxt(), nxt()) for _ in range(aw)]
        sels = tuple(nxt() for _ in range(3))
        periodic = [nxt() for _ in range(p)]
        pubs = [nxt() for _ in range(n_pub)]
        rands = [(nxt(), nxt()) for _ in range(n_rand)]
        auxvs = [(nxt(), nxt()) for _ in range(n_auxv)]
        alpha = (nxt(), nxt())

        f = Folder(
            be,
            main_fn=lambda c, o=0: Expr(be, "base", (main_next if o else main_cur)[c]),
            aux_fn=lambda c, o=0: Expr(be, "ext", (aux_next if o else aux_cur)[c]),
            preprocessed_fn=lambda c, o=0: Expr(be, "base", (pp_next if o else pp_cur)[c]),
            periodic=[Expr(be, "base", r) for r in periodic],
            publics=[Expr(be, "base", r) for r in pubs],
            randomness=[Expr(be, "ext", r) for r in rands],
            aux_values=[Expr(be, "ext", r) for r in auxvs],
            selectors=tuple(Expr(be, "base", r) for r in sels),
            alpha=Expr(be, "ext", alpha),
        )
        air.eval(f)
        assert f.acc is not None, "AIR produced no constraints"
        if f.acc.kind == "base":
            # single-constraint AIRs never touch α: lift base → ext
            f.acc = Expr(be, "ext", be._ext(f.acc.val, "base"))
        assert f.acc.kind == "ext"
        self.num_constraints = f.num_constraints
        self.n_inputs = n_inputs
        self.const_values = be.const_values
        self.n_fixed = be.n_fixed
        #: instructions to run (``code`` keeps one row when there are none)
        self.n_instr = len(be.instrs)
        self._allocate(be.instrs, f.acc.val)
        self._vec_sources = (
            [(0, c, 0) for c in range(w)] + [(0, c, 1) for c in range(w)]
            + [(1, c, 0) for c in range(pw)] + [(1, c, 1) for c in range(pw)]
            + [(2, c, 0) for c in range(2 * aw)] + [(2, c, 1) for c in range(2 * aw)]
            + [(3, c, 0) for c in range(3 + p)]
        )
        assert len(self._vec_sources) == self.n_vec
        self._schedules: dict = {}
        self._schedule_code: dict = {}  # (on_chip, device) -> Q1's packed stream on the device

    def _allocate(self, instrs, out_regs) -> None:
        """Linear-scan register reuse over the SSA stream. Slot 0 is a
        dedicated scratch sink for dead results."""
        n_fixed = self.n_fixed
        n = len(instrs)
        last_use: dict[int, int] = {}
        for i, (_, a, b) in enumerate(instrs):
            for r in (a, b):
                if r >= n_fixed:
                    last_use[r] = i
        for r in out_regs:
            if r >= n_fixed:
                last_use[r] = n

        free: list[int] = []
        mapping: dict[int, int] = {}
        frame_size = 1  # slot 0 = scratch
        code = np.zeros((max(n, 1), 4), dtype=np.int32)
        for i, (op, a, b) in enumerate(instrs):
            ra = a if a < n_fixed else n_fixed + mapping[a]
            rb = b if b < n_fixed else n_fixed + mapping[b]
            for r in (a, b):
                if r >= n_fixed and last_use.get(r) == i and r in mapping:
                    free.append(mapping.pop(r))
            ssa = n_fixed + i
            if ssa in last_use:
                slot = free.pop() if free else frame_size
                if slot == frame_size:
                    frame_size += 1
                mapping[ssa] = slot
            else:
                slot = 0
            code[i] = (op, ra, rb, n_fixed + slot)
        self.code = code
        self.frame_size = frame_size
        self.out_slots = tuple(
            r if r < n_fixed else n_fixed + mapping[r] for r in out_regs
        )

    def schedule(self, on_chip: int) -> Schedule:
        """Q1's :class:`Schedule` of this program with at most ``on_chip``
        frame slots in shared memory, made once."""
        sched = self._schedules.get(on_chip)
        if sched is None:
            sched = self._schedules[on_chip] = make_schedule(self, on_chip)
        return sched


_PROGRAM_CACHE: dict = {}


def get_program(air: Air, n_pub: int, n_rand: int, n_auxv: int) -> ConstraintProgram:
    key = (type(air), n_pub, n_rand, n_auxv)
    prog = _PROGRAM_CACHE.get(key)
    if prog is None:
        prog = ConstraintProgram(air, n_pub, n_rand, n_auxv)
        _PROGRAM_CACHE[key] = prog
    return prog


@dataclass
class ProgramInputs:
    """What one run of a program reads. ``sources``: the four per-point
    matrices of the vector block, as (nd, k) tensors that may be row-strided
    views of an LDE (main, preprocessed, aux; None where the AIR has none)
    and the (3 + p, nd) matrix of selectors and periodic columns; ``scal``:
    the (n_fixed − n_vec,) scalar block; point i's next row is
    ``(i + next_offset) & (nd − 1)``."""

    sources: tuple
    scal: torch.Tensor
    nd: int
    next_offset: int


def program_inputs(
    air: Air,
    main: torch.Tensor,  # (nd, w)
    aux: torch.Tensor | None,  # (nd, 2aw), c0/c1 interleaved per column
    selectors: tuple,  # 3 × (nd,)
    publics: torch.Tensor,  # (n_pub,)
    randomness: torch.Tensor,  # (n_rand, 2)
    aux_values: torch.Tensor,  # (n_auxv, 2)
    periodic: list,  # p × (nd,)
    alpha: torch.Tensor,  # (2,)
    pp: torch.Tensor | None = None,  # (nd, pw)
    next_offset: int = 1,
) -> tuple:
    """The AIR's program and what one run of it reads, ``(prog,
    ProgramInputs)``, from the arguments of
    :func:`evaluate_folded_constraints`."""
    nd = main.shape[0]
    assert nd & (nd - 1) == 0, "the quotient domain is a power of two"
    prog = get_program(air, int(publics.shape[0]), int(randomness.shape[0]), int(aux_values.shape[0]))
    consts = F.table(prog.const_values, main.device)
    scal = torch.cat([publics.reshape(-1), randomness.reshape(-1), aux_values.reshape(-1),
                      alpha.reshape(-1), consts])
    assert prog.n_vec + scal.shape[0] == prog.n_fixed
    points = torch.stack([*selectors, *periodic])
    return prog, ProgramInputs(
        sources=(main, pp if air.preprocessed_width else None, aux if air.aux_width else None, points),
        scal=scal, nd=nd, next_offset=next_offset,
    )


def evaluate_folded_constraints(air: Air, main, aux, selectors, publics, randomness, aux_values,
                                periodic, alpha, pp=None, next_offset: int = 1) -> torch.Tensor:
    """The α-folded constraint accumulator (nd, 2) via the recorded program;
    equal value for value to the eager evaluator. ``main`` (nd, w), ``aux``
    (nd, 2aw, c0/c1 interleaved per column) and ``pp`` (nd, pw) may be
    row-strided views (the quotient coset inside an LDE): the next row of
    point r is read at ``(r + next_offset) mod nd``, with no rolled copy.
    ``selectors`` and ``periodic`` are (nd,) columns, ``publics`` (n_pub,),
    ``randomness`` and ``aux_values`` (k, 2), ``alpha`` (2,)."""
    return run_program(*program_inputs(air, main, aux, selectors, publics, randomness, aux_values,
                                       periodic, alpha, pp, next_offset))


def run_program(prog: ConstraintProgram, inp: ProgramInputs) -> torch.Tensor:
    """The program over every point: Q1 on CUDA tensors, the plain twin on
    CPU tensors."""
    if inp.scal.is_cuda:
        return run_program_kernel(prog, inp)
    return run_program_plain(prog, inp)


# -- the plain twin -----------------------------------------------------------------

_OPS = (F.add, F.sub, F.mul)

#: elements (frame slots + vector inputs, per point) of one block of the plain
#: twin: 2^30 int64 values, at most 8 GiB live a block. Every instruction is
#: some 25 torch launches over a block, so on a card the block is as large
#: as a card holds beside a proof's LDEs (2^20 points for the VM core)
PLAIN_BLOCK_ELEMS = 1 << 30


def plain_block_points(prog: ConstraintProgram, n: int) -> int:
    """Points of one block of the plain twin: the largest power of two whose
    frame slots and vector inputs fit PLAIN_BLOCK_ELEMS elements (at least
    one point), at most ``n``."""
    per_point = prog.frame_size + prog.n_vec
    blk = 1
    while blk < n and per_point * (blk << 1) <= PLAIN_BLOCK_ELEMS:
        blk <<= 1
    return min(blk, n)


def run_program_plain(prog: ConstraintProgram, inp: ProgramInputs, points=None) -> torch.Tensor:
    """Plain twin of Q1: a Python loop over the instructions, each one
    torch field op over a block of points (``F.add`` / ``F.sub`` /
    ``F.mul``), its operands read from the gathered vector inputs, the
    scalar block (never broadcast) or the frame. Evaluates every point, or
    only ``points`` (an int64 tensor of point indices); returns
    (points, 2)."""
    nd, d = inp.nd, inp.next_offset
    device = inp.scal.device
    n = nd if points is None else int(points.shape[0])
    scal = list(inp.scal.unbind(0))
    code = prog.code[: prog.n_instr].tolist()
    out = torch.empty((n, 2), dtype=torch.int64, device=device)
    blk = plain_block_points(prog, n)
    for start in range(0, n, blk):
        stop = min(start + blk, n)
        cur = (torch.arange(start, stop, device=device) if points is None
               else points[start:stop].to(device))
        nxt = (cur + d) & (nd - 1)
        vec = []
        for s, src in enumerate(inp.sources):
            if src is None:
                continue
            if s == 3:  # (3 + p, nd): columns are rows
                vec += list(src.index_select(1, cur).unbind(0))
                continue
            vec += list(src.index_select(0, cur).T.contiguous().unbind(0))
            vec += list(src.index_select(0, nxt).T.contiguous().unbind(0))
        assert len(vec) == prog.n_vec
        regs = vec + scal + [None] * prog.frame_size
        for op, a, b, dst in code:
            regs[dst] = _OPS[op](regs[a], regs[b])
        for c, r in enumerate(prog.out_slots):
            out[start:stop, c] = regs[r]
    return out


# -- Q1's schedule ----------------------------------------------------------------------
#
# Q1 does not run the recorded order. The host reorders the program once
# (depth first from the two outputs, the larger operand first, so that a
# value is read soon after it is made), loads an input read again within
# LOAD_WINDOW instructions into the frame once, and allocates the frame
# anew: a result read only by the next instruction stays in a register and
# is never stored, and the stored values are split between ON-CHIP slots
# (shared memory) and an OFF-CHIP remainder (a device scratch), the
# on-chip ones chosen by how often they are read over their lifetime.
# Every value is the same field operation on the same operands as in the
# recorded program, so the outputs are bit for bit the same.

#: where an operand lives (two bits of a scheduled instruction)
KIND_ON, KIND_OFF, KIND_SCALAR, KIND_INPUT = 0, 1, 2, 3
#: the destination kind of a result that only the next instruction reads
DST_NONE = 2
#: bits of each offset (destination, operand a, operand b) of a scheduled instruction
OFFSET_BITS = 16
#: bit 10 of a scheduled instruction: it reads an off-chip slot or an input,
#: or stores off chip, and takes the kernel's general path (:func:`is_rare`);
#: the others read only the previous result, on-chip slots and scalars
_RARE = 1 << 10
#: an input read again within this many scheduled instructions is loaded
#: into the frame once (a LOAD: the input plus the constant 0) and read there
LOAD_WINDOW = 128
#: instructions a warp fetches at once; the packed stream is padded to a
#: multiple, plus one batch that is fetched ahead and never run
BATCH = 32
_A_PREV, _B_PREV = 1 << 8, 1 << 9
#: an instruction that reads only the previous result and stores nothing
_PAD = 0 | DST_NONE << 2 | _A_PREV | _B_PREV
#: heuristic subtree sizes are capped (a DAG's tree size grows exponentially)
_SIZE_CAP = 1 << 40


@dataclass
class Schedule:
    """Q1's tables for one program and one on-chip slot budget.

    ``code`` holds one u64 a scheduled instruction (``n_instr`` of them,
    padded with no-ops to ``n_run``, a multiple of BATCH, plus one batch):
    op in bits 0-1 (ADD, SUB, MUL), the destination's kind in 2-3 (KIND_ON,
    KIND_OFF or DST_NONE), operand a's and b's kinds in 4-5 and 6-7, bit
    8 / 9 set where a / b is the previous instruction's result,
    :func:`is_rare` in bit 10, and the destination's, a's and b's offsets
    in bits 16, 32 and 48 (OFFSET_BITS each): a slot, a scalar's index in
    the scalar block, or an input's descriptor ``column << 3 | next row <<
    2 | source`` (:func:`encode`). A LOAD adds the constant 0 to its input.
    ``outs`` are the two outputs as ``kind | offset << 2``. ``order`` is the
    scheduled stream: the index of a recorded instruction, or ``~r`` for a
    LOAD of vector register r. The frame has ``n_on`` on-chip slots and
    ``n_off`` off-chip ones."""

    order: np.ndarray
    code: np.ndarray
    n_instr: int
    n_run: int
    outs: tuple
    n_on: int
    n_off: int
    #: per point: stores, frame reads, previous-result reads, on-chip accesses, global input reads
    stores: int
    frame_reads: int
    prev_reads: int
    on_chip_accesses: int
    input_reads: int

    @property
    def frame_size(self) -> int:
        return self.n_on + self.n_off


def _ssa(prog: ConstraintProgram) -> tuple:
    """The recorded stream as SSA: per instruction (op, a, b), an operand
    ``>= 0`` the index of the instruction that made it and ``< 0`` the
    input or scalar register ``~ref``; the two outputs likewise."""
    nf = prog.n_fixed
    writer: dict = {}
    ops = []
    for i, (op, a, b, d) in enumerate(prog.code[: prog.n_instr].tolist()):
        ops.append((op, writer[a] if a >= nf else ~a, writer[b] if b >= nf else ~b))
        writer[d] = i
    return ops, [writer[r] if r >= nf else ~r for r in prog.out_slots]


def _depth_first(ops: list, outs: list) -> list:
    """A topological order of the instructions: depth first from the
    outputs, each instruction after its operands, the operand with the
    larger subtree first; instructions no output reads (dead results)
    follow, in recorded order."""
    size = [0] * len(ops)
    for i, (_, a, b) in enumerate(ops):
        size[i] = min(_SIZE_CAP, 1 + (size[a] if a >= 0 else 0) + (size[b] if b >= 0 else 0))
    seen = bytearray(len(ops))
    order = []
    for root in [o for o in outs if o >= 0] + list(range(len(ops))):
        stack = [(root, False)]
        while stack:
            x, ready = stack.pop()
            if seen[x]:
                continue
            if ready:
                seen[x] = 1
                order.append(x)
                continue
            stack.append((x, True))
            _, a, b = ops[x]
            kids = [k for k in (a, b) if k >= 0 and not seen[k]]
            if len(kids) == 2 and size[kids[1]] > size[kids[0]]:
                kids.reverse()
            stack.extend((k, False) for k in reversed(kids))
    return order


def _with_loads(ops: list, order: list, prog: ConstraintProgram) -> tuple:
    """Groups each input's reads in ``order`` into runs whose neighbours
    lie within LOAD_WINDOW instructions; a run of two or more reads becomes
    one LOAD, the input plus the constant 0 (appended to ``ops``, placed
    just before the run's first read), whose result they read. Returns
    (ops, stream)."""
    n_vec, zero = prog.n_vec, prog.n_inputs + prog.const_values.index(0)
    reads: dict = {}
    for t, i in enumerate(order):
        _, a, b = ops[i]
        for k, r in ((1, a), (2, b)):
            if r < 0 and ~r < n_vec:
                reads.setdefault(~r, []).append((t, i, k))
    ops = [list(o) for o in ops]
    before: dict = {}
    for reg in sorted(reads):
        runs = [[reads[reg][0]]]
        for u in reads[reg][1:]:
            if u[0] - runs[-1][-1][0] <= LOAD_WINDOW:
                runs[-1].append(u)
            else:
                runs.append([u])
        for run in runs:
            if len(run) < 2:
                continue
            v = len(ops)
            ops.append([OP_ADD, ~reg, ~zero])
            for _, i, k in run:
                ops[i][k] = v
            before.setdefault(run[0][0], []).append(v)
    stream = []
    for t, i in enumerate(order):
        stream += before.get(t, [])
        stream.append(i)
    return [tuple(o) for o in ops], stream


def make_schedule(prog: ConstraintProgram, on_chip: int) -> Schedule:
    """Schedules ``prog`` for Q1 with at most ``on_chip`` on-chip slots
    (see the comment at the head of this section)."""
    ops, outs = _ssa(prog)
    ops, stream = _with_loads(ops, _depth_first(ops, outs), prog)
    n, n_vals = len(stream), len(ops)
    pos = np.empty(n_vals, dtype=np.int64)
    pos[stream] = np.arange(n)

    def is_prev(r: int, t: int) -> bool:
        return r >= 0 and pos[r] == t - 1

    # a value is stored where some instruction other than the next reads it, or it is an output
    last = np.full(n_vals, -1, dtype=np.int64)
    reads = np.zeros(n_vals, dtype=np.int64)
    prev_reads = input_reads = 0
    for t, v in enumerate(stream):
        _, a, b = ops[v]
        for r in (a, b):
            if is_prev(r, t):
                prev_reads += 1
            elif r >= 0:
                reads[r] += 1
                last[r] = t
            elif ~r < prog.n_vec:
                input_reads += 1
    for r in outs:
        if r >= 0:
            reads[r] += 1
            last[r] = n
    vals = np.nonzero(last >= 0)[0]
    start, stop = pos[vals], last[vals]

    # on chip: the values with the most accesses (a store and its reads) per
    # instruction of lifetime, as long as no more than on_chip are live at once
    on = np.zeros(n_vals, dtype=bool)
    live = np.zeros(n + 1, dtype=np.int32)
    density = (1 + reads[vals]) / (stop - start)
    for j in np.lexsort((start, -density)):
        p, q = start[j], stop[j]
        if on_chip and live[p:q].max() < on_chip:
            live[p:q] += 1
            on[vals[j]] = True

    # slots: a linear scan per pool; a value's slot is free again at its last read
    ends: dict = {}
    for v in vals.tolist():
        ends.setdefault(int(last[v]), []).append(v)
    slot = np.full(n_vals, -1, dtype=np.int64)
    free: tuple = ([], [])
    count = [0, 0]
    for t, v in enumerate(stream):
        for u in ends.get(t, ()):
            free[0 if on[u] else 1].append(int(slot[u]))
        if last[v] >= 0:
            pool = 0 if on[v] else 1
            slot[v] = free[pool].pop() if free[pool] else count[pool]
            count[pool] = max(count[pool], int(slot[v]) + 1)

    def operand(r: int) -> tuple:
        if r >= 0:
            return (KIND_ON if on[r] else KIND_OFF), int(slot[r])
        reg = ~r
        if reg < prog.n_vec:
            s, col, nx = prog._vec_sources[reg]
            return KIND_INPUT, col << 3 | nx << 2 | s
        return KIND_SCALAR, reg - prog.n_vec

    limit = 1 << OFFSET_BITS
    n_run = -(-n // BATCH) * BATCH
    code = np.full(n_run + BATCH, _PAD, dtype=np.uint64)
    for t, v in enumerate(stream):
        op, a, b = ops[v]
        dst = (DST_NONE, 0) if last[v] < 0 else ((KIND_ON if on[v] else KIND_OFF), int(slot[v]))
        args = [None if is_prev(r, t) else operand(r) for r in (a, b)]
        for x in [dst] + [x for x in args if x is not None]:
            if x[1] >= limit:
                raise ValueError(f"{type(prog.air).__name__}: offset {x[1]} does not fit Q1's {OFFSET_BITS}-bit fields")
        code[t] = encode(op, dst, *args)
    outs_packed = tuple(kind | off << 2 for kind, off in map(operand, outs))
    on_accesses = int((on[vals] * (1 + reads[vals])).sum())
    return Schedule(
        order=np.asarray([v if v < prog.n_instr else ops[v][1] for v in stream], dtype=np.int64),
        code=code.view(np.int64), n_instr=n, n_run=n_run, outs=outs_packed, n_on=count[0], n_off=count[1],
        stores=len(vals), frame_reads=int(reads[vals].sum()) - sum(1 for r in outs if r >= 0),
        prev_reads=prev_reads, on_chip_accesses=on_accesses, input_reads=input_reads,
    )


def is_rare(dst: tuple, a, b) -> bool:
    """Whether an instruction takes the kernel's general path: it reads an
    off-chip slot or an input, or stores off chip."""
    return dst[0] == KIND_OFF or any(x is not None and x[0] in (KIND_OFF, KIND_INPUT) for x in (a, b))


def encode(op: int, dst: tuple, a, b) -> int:
    """One packed scheduled instruction (see :class:`Schedule`); ``dst`` is
    (kind, offset), an operand None where it is the previous instruction's
    result, else (kind, offset)."""
    word = op | dst[0] << 2 | (_RARE if is_rare(dst, a, b) else 0) | dst[1] << 16
    for x, flag, kind_at, off_at in ((a, _A_PREV, 4, 32), (b, _B_PREV, 6, 48)):
        word |= flag if x is None else x[0] << kind_at | x[1] << off_at
    return word


def decode(word: int) -> tuple:
    """The inverse of :func:`encode`: (op, (dst kind, dst offset), a, b)."""
    mask = (1 << OFFSET_BITS) - 1
    a = None if word & _A_PREV else ((word >> 4) & 3, (word >> 32) & mask)
    b = None if word & _B_PREV else ((word >> 6) & 3, (word >> 48) & mask)
    return word & 3, ((word >> 2) & 3, (word >> 16) & mask), a, b


def run_schedule_plain(prog: ConstraintProgram, sched: Schedule, inp: ProgramInputs) -> torch.Tensor:
    """Plain reader of Q1's own tables: the scheduled stream, decoded from
    the packed words as the kernel decodes them, over every point at once
    (torch field ops; a small-``nd`` check of the schedule and its packing,
    on the CPU). Returns (nd, 2)."""
    nd, device = inp.nd, inp.scal.device
    cur = torch.arange(nd, device=device)
    rows = (cur, (cur + inp.next_offset) & (nd - 1))
    frames = ([None] * sched.n_on, [None] * sched.n_off)
    prev = None

    def fetch(kind: int, off: int):
        if kind in (KIND_ON, KIND_OFF):
            return frames[kind][off]
        if kind == KIND_SCALAR:
            return inp.scal[off]
        s, nx, col = off & 3, (off >> 2) & 1, off >> 3
        src = inp.sources[s]
        return src[col] if s == 3 else src[:, col].index_select(0, rows[nx])

    for word in sched.code[: sched.n_instr].view(np.uint64).tolist():
        op, (dkind, doff), a, b = decode(word)
        va = prev if a is None else fetch(*a)
        vb = prev if b is None else fetch(*b)
        r = _OPS[op](va, vb)
        if dkind != DST_NONE:
            frames[dkind][doff] = r
        prev = r
    out = torch.empty((nd, 2), dtype=torch.int64, device=device)
    for c, o in enumerate(sched.outs):
        out[:, c] = fetch(o & 3, o >> 2)
    return out


# -- Q1 ---------------------------------------------------------------------------------

#: Q1 (``csrc/constraints.cu``): one launch per program run over a quotient coset
Q1_KERNEL = cuda.Kernel(
    "constraints", "constraints_eval",
    [cuda.P, cuda.I64, cuda.P, cuda.I32,
     cuda.P, cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I64, cuda.I64, cuda.I64,
     cuda.I64, cuda.I64, cuda.I64, cuda.I64,
     cuda.P, cuda.I32, cuda.I32, cuda.I32, cuda.I32, cuda.P, cuda.I64, cuda.I64, cuda.I32, cuda.I32, cuda.P],
    "constraints_eval_kernel",
)


@dataclass(frozen=True)
class Q1Setting:
    """How Q1 launches: ``points`` a thread evaluates with each decoded
    instruction (1, 2 or 4), ``block`` threads a block (a multiple of 32, at
    most 256), at most ``on_chip`` frame slots a point in shared memory, and
    the bytes the off-chip remainder may take (the grid is cut to fit:
    grid × points a block × off-chip slots × 8 B). The defaults are the
    fastest of ``bench_quotient --sweep`` on the VM core's 2^21 points:
    Q1 waits on each instruction's result, so it runs faster with more
    points in flight an SM, and few on-chip slots leave room for them."""

    points: int = 2
    block: int = 64
    on_chip: int = 8
    spill_bytes: int = 512 << 20


#: the setting Q1 launches with unless a caller gives one
Q1_DEFAULT = Q1Setting()


@dataclass
class Q1Plan:
    """One launch of Q1: the schedule, the grid and its shared memory."""

    sched: Schedule
    setting: Q1Setting
    blocks: int
    blocks_per_sm: int
    shared_bytes: int

    @property
    def tile(self) -> int:
        """Points a block evaluates at once."""
        return self.setting.block * self.setting.points

    @property
    def spill_bytes(self) -> int:
        return 8 * self.sched.n_off * self.blocks * self.tile

    def describe(self) -> dict:
        return {"k": self.setting.points, "block": self.setting.block, "tile": self.tile,
                "on_chip_slots": self.sched.n_on, "off_chip_slots": self.sched.n_off,
                "blocks": self.blocks, "blocks_per_sm": self.blocks_per_sm,
                "shared_bytes": self.shared_bytes, "spilled_bytes": self.spill_bytes}


_occupancy: dict = {}


def q1_plan(prog: ConstraintProgram, nd: int, setting: Q1Setting = Q1_DEFAULT) -> Q1Plan:
    """Q1's launch for ``prog`` over nd points: a persistent grid of as many
    blocks as the card holds at once with this setting's shared memory,
    fewer where the tiles run out or the off-chip remainder would pass
    ``setting.spill_bytes`` (at least one block). Raises where the card
    holds no block of this setting."""
    if setting.points not in (1, 2, 4) or setting.block % 32 or not 32 <= setting.block <= 256:
        raise ValueError(f"Q1: unsupported setting {setting}")
    sched = prog.schedule(setting.on_chip)
    tile = setting.block * setting.points
    smem = 8 * (prog.n_fixed - prog.n_vec + sched.n_on * tile)
    key = (setting.points, setting.block, smem)
    if key not in _occupancy:
        fn = cuda.load("constraints").constraints_occupancy
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        err = fn(setting.points, setting.block, smem, ctypes.byref(per_sm), ctypes.byref(sms))
        if err != 0:
            raise cuda.KernelError(f"constraints_occupancy: CUDA error {err} ({smem} bytes of shared memory)")
        if per_sm.value < 1:
            raise cuda.KernelError(f"Q1: no block of {setting} ({smem} bytes of shared memory) fits an SM")
        _occupancy[key] = (per_sm.value, sms.value)
    per_sm, sms = _occupancy[key]
    blocks = min(per_sm * sms, -(-nd // tile))
    if sched.n_off:
        blocks = min(blocks, max(1, setting.spill_bytes // (8 * sched.n_off * tile)))
    return Q1Plan(sched=sched, setting=setting, blocks=blocks, blocks_per_sm=per_sm, shared_bytes=smem)


def run_program_kernel(prog: ConstraintProgram, inp: ProgramInputs, setting: Q1Setting = Q1_DEFAULT) -> torch.Tensor:
    """Q1 on CUDA tensors: the program over every point of the coset."""
    nd = inp.nd
    if nd < 1 or nd & (nd - 1):
        raise ValueError(f"Q1: the domain size must be a power of two, got {nd}")
    cuda.check_tensor(inp.scal, "Q1 scalar block", (prog.n_fixed - prog.n_vec,))
    ptrs, point_strides, col_strides = [], [], []
    for s, src in enumerate(inp.sources):
        if src is None:
            ptrs.append(0)
            point_strides.append(0)
            col_strides.append(0)
            continue
        if not src.is_cuda or src.dtype != torch.int64 or src.ndim != 2:
            raise ValueError(f"Q1 source {s}: expected a 2-d CUDA int64 tensor, got {src.dtype} "
                             f"{tuple(src.shape)} on {src.device}")
        point_dim = 1 if s == 3 else 0
        if src.shape[point_dim] != nd:
            raise ValueError(f"Q1 source {s}: {src.shape[point_dim]} points, expected {nd}")
        ptrs.append(src.data_ptr())
        point_strides.append(src.stride(point_dim))
        col_strides.append(src.stride(1 - point_dim))
    device = inp.scal.device
    plan = q1_plan(prog, nd, setting)
    sched = plan.sched
    code = prog._schedule_code.get((setting.on_chip, str(device)))
    if code is None:
        code = prog._schedule_code[(setting.on_chip, str(device))] = torch.from_numpy(sched.code).to(device)
    spill = torch.empty((max(1, plan.spill_bytes // 8),), dtype=torch.int64, device=device)
    out = torch.empty((nd, 2), dtype=torch.int64, device=device)
    Q1_KERNEL.launch(
        code.data_ptr(), sched.n_run, inp.scal.data_ptr(), prog.n_fixed - prog.n_vec,
        *ptrs, *point_strides, *col_strides, spill.data_ptr(), sched.n_on, setting.points, setting.block,
        plan.blocks, out.data_ptr(), nd, inp.next_offset, *sched.outs, key=(type(prog.air).__name__, nd),
    )
    return out
