"""Recording of an AIR's constraint fold as base-field SSA instructions
(:class:`RecordBackend`, :func:`_collect_constants`), which the ACE codegen
lowers to the circuits whose commitments seed the VM's Fiat-Shamir
challenger. A copy of the recording half of the port's ``stark/interp.py``;
the evaluator and its kernel are the prover's, not copied.
"""

from __future__ import annotations

from .. import gl
from ..air import Air, Expr, Folder, ScalarBackend

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

