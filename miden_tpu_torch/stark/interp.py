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
coset: on CUDA tensors as kernel Q1 (``csrc/constraints.cu``), on CPU
tensors as the plain twin :func:`run_program_plain`, a Python loop over the
instructions. The prover sends the VM AIRs (``prefer_interp``) and every
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
        self._device_arrays: dict = {}

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

    def device_arrays(self, device) -> tuple:
        """Q1's tables on ``device``, made once: the instructions packed one
        to a u64 (a | b << 20 | dst << 40 | op << 60) and one u32 per vector
        register (source | next row << 2 | column << 3; sources 0 main, 1
        preprocessed, 2 aux, 3 selectors and periodic columns)."""
        key = str(device)
        arrays = self._device_arrays.get(key)
        if arrays is None:
            if self.n_fixed + self.frame_size > _ID_LIMIT:
                raise ValueError(f"{type(self.air).__name__}: {self.n_fixed + self.frame_size} registers, "
                                 f"Q1 takes at most {_ID_LIMIT}")
            c = self.code[: self.n_instr].astype(np.uint64)
            packed = c[:, 1] | c[:, 2] << np.uint64(20) | c[:, 3] << np.uint64(40) | c[:, 0] << np.uint64(60)
            desc = np.asarray([s | nx << 2 | col << 3 for s, col, nx in self._vec_sources], dtype=np.int32)
            arrays = (
                torch.from_numpy(packed.view(np.int64).copy()).to(device),
                torch.from_numpy(desc).to(device),
            )
            self._device_arrays[key] = arrays
        return arrays


#: register ids are 20-bit fields of Q1's packed instructions
_ID_LIMIT = 1 << 20

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
    consts = F.to_torch(np.asarray(prog.const_values, dtype=np.uint64), main.device)
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


# -- Q1 ---------------------------------------------------------------------------------

#: Q1 (``csrc/constraints.cu``): one launch per program run over a quotient coset
Q1_KERNEL = cuda.Kernel(
    "constraints", "constraints_eval",
    [cuda.P, cuda.I64, cuda.P, cuda.I32, cuda.P, cuda.I32,
     cuda.P, cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I64, cuda.I64, cuda.I64,
     cuda.I64, cuda.I64, cuda.I64, cuda.I64,
     cuda.P, cuda.I64, cuda.P, cuda.I64, cuda.I64, cuda.I32, cuda.I32, cuda.P],
)
#: device bytes Q1's frame scratch may take: the grid is cut below the
#: resident threads when their frames would not fit
FRAME_BUDGET_BYTES = 1 << 30
_BLOCK = 128  # kBlock of csrc/constraints.cu


_resident: dict = {}


def q1_threads(prog: ConstraintProgram, nd: int) -> int:
    """Threads of Q1's grid for ``prog`` over nd points: as many as the card
    holds at once, fewer where the frames would exceed FRAME_BUDGET_BYTES or
    the points run out; a multiple of the block size."""
    key = (prog.n_vec, prog.n_fixed)
    if key not in _resident:
        fn = cuda.load("constraints").constraints_resident_threads
        fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int64)]
        fn.restype = ctypes.c_int
        threads = ctypes.c_int64(0)
        err = fn(prog.n_vec, prog.n_fixed, ctypes.byref(threads))
        if err != 0:
            raise cuda.KernelError(f"constraints_resident_threads: CUDA error {err}")
        _resident[key] = threads.value
    by_budget = FRAME_BUDGET_BYTES // (8 * prog.frame_size)
    threads = min(_resident[key], by_budget, -(-nd // _BLOCK) * _BLOCK)
    return max(_BLOCK, threads // _BLOCK * _BLOCK)


def run_program_kernel(prog: ConstraintProgram, inp: ProgramInputs) -> torch.Tensor:
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
    code, desc = prog.device_arrays(inp.scal.device)
    threads = q1_threads(prog, nd)
    frame = torch.empty((prog.frame_size * threads,), dtype=torch.int64, device=inp.scal.device)
    out = torch.empty((nd, 2), dtype=torch.int64, device=inp.scal.device)
    Q1_KERNEL.launch(
        code.data_ptr(), prog.n_instr, desc.data_ptr(), prog.n_vec, inp.scal.data_ptr(), prog.n_fixed,
        *ptrs, *point_strides, *col_strides, frame.data_ptr(), threads, out.data_ptr(), nd,
        inp.next_offset, *prog.out_slots, key=(type(prog.air).__name__, nd),
    )
    return out
