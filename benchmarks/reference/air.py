"""AIR interface, as the verifier evaluates it: one constraint definition
(``Air.eval`` over a :class:`Folder`) on two backends.

- :class:`ScalarBackend` — exact Python ints at the OOD point (verifier);
- :class:`DegreeBackend` — degree-multiple tracking (quotient sizing).

Constraints are α-folded Horner-style in ``assert_*`` order
(``acc ← acc·α + c``), as the prover folds them. A copy of the port's
``stark/air.py`` without its vector (torch) backend, which only the prover
runs.
"""

from __future__ import annotations

from typing import Sequence

from . import gl

class ScalarBackend:
    """Values are Python ints (base) / (c0, c1) tuples (ext).

    Stacked constraint families (``main_many`` / ``assert_*_many``) are
    Python lists operated on elementwise, mirroring the vector backend's
    leading group axis.
    """

    kind = "scalar"

    def const(self, c: int):
        return c % gl.P

    def mul_int(self, v, c: int, kind: str):
        c %= gl.P
        if kind == "base":
            if isinstance(v, list):
                return [gl.mul(x, c) for x in v]
            return gl.mul(v, c)
        if isinstance(v, list):
            return [gl.ext_mul_base(x, c) for x in v]
        return gl.ext_mul_base(v, c)

    def _zip(self, a, b, f):
        if isinstance(a, list) or isinstance(b, list):
            if not isinstance(a, list):
                a = [a] * len(b)
            if not isinstance(b, list):
                b = [b] * len(a)
            assert len(a) == len(b)
            return [f(x, y) for x, y in zip(a, b)]
        return f(a, b)

    def add(self, a, b, ka, kb):
        if ka == "base" and kb == "base":
            return self._zip(a, b, gl.add)
        return self._zip(self._ext(a, ka), self._ext(b, kb), gl.ext_add)

    def sub(self, a, b, ka, kb):
        if ka == "base" and kb == "base":
            return self._zip(a, b, gl.sub)
        return self._zip(self._ext(a, ka), self._ext(b, kb), gl.ext_sub)

    def mul(self, a, b, ka, kb):
        if ka == "base" and kb == "base":
            return self._zip(a, b, gl.mul)
        if ka == "base":
            return self._zip(b, a, lambda x, y: gl.ext_mul_base(x, y))
        if kb == "base":
            return self._zip(a, b, lambda x, y: gl.ext_mul_base(x, y))
        return self._zip(a, b, gl.ext_mul)

    def _ext(self, v, k):
        if k == "ext":
            return v
        if isinstance(v, list):
            return [(x, 0) for x in v]
        return (v, 0)


class DegreeBackend:
    """Values are degree multiples (trace column = 1)."""

    kind = "degree"

    def const(self, c: int):
        return 0

    def mul_int(self, v, c: int, kind: str):
        return v

    def add(self, a, b, ka, kb):
        return max(a, b)

    sub = add

    def mul(self, a, b, ka, kb):
        return a + b


class Expr:
    """Backend-dispatched value with operator overloading."""

    __slots__ = ("backend", "kind", "val")

    def __init__(self, backend, kind, val):
        self.backend = backend
        self.kind = kind
        self.val = val

    def _coerce(self, other) -> "Expr":
        if isinstance(other, Expr):
            return other
        if isinstance(other, int):
            return Expr(self.backend, "base", self.backend.const(other))
        raise TypeError(f"cannot mix Expr with {type(other)}")

    def _bin(self, other, op):
        other = self._coerce(other)
        kind = "ext" if "ext" in (self.kind, other.kind) else "base"
        if isinstance(self.backend, DegreeBackend):
            kind = "base"
        return Expr(self.backend, kind, op(self.val, other.val, self.kind, other.kind))

    def __add__(self, other):
        return self._bin(other, self.backend.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._bin(other, self.backend.sub)

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        if isinstance(other, int) and hasattr(self.backend, "mul_int"):
            return Expr(self.backend, self.kind, self.backend.mul_int(self.val, other, self.kind))
        return self._bin(other, self.backend.mul)

    __rmul__ = __mul__

    def __neg__(self):
        return self._coerce(0).__sub__(self)


# ---------------------------------------------------------------------------
# Folder
# ---------------------------------------------------------------------------


class Folder:
    """Constraint accumulation context handed to ``Air.eval``. The value
    callbacks (``main_fn``, ``aux_fn``, …) come from the prover (vector),
    the verifier (scalar) or the degree analyzer."""

    def __init__(
        self,
        backend,
        *,
        main_fn,
        aux_fn=None,
        preprocessed_fn=None,
        periodic=(),
        publics=(),
        randomness=(),
        aux_values=(),
        selectors=None,
        alpha=None,
    ):
        self.backend = backend
        self._main = main_fn
        self._aux = aux_fn
        self._preprocessed = preprocessed_fn
        self._periodic = list(periodic)
        self._publics = list(publics)
        self._randomness = list(randomness)
        self._aux_values = list(aux_values)
        self._selectors = selectors
        self._alpha = alpha
        self.acc = None  # α-folded accumulator
        self.num_constraints = 0

    # --- value access ---
    def main(self, col: int, offset: int = 0) -> Expr:
        return self._main(col, offset)

    def aux(self, col: int, offset: int = 0) -> Expr:
        return self._aux(col, offset)

    def preprocessed(self, col: int, offset: int = 0) -> Expr:
        return self._preprocessed(col, offset)

    def main_many(self, cols, offset: int = 0) -> Expr:
        """Stacked access to a list of main columns: one Expr with a leading
        group axis, for the ``assert_*_many`` sinks."""
        cols = list(cols)
        if isinstance(self.backend, DegreeBackend):
            return Expr(self.backend, "base", 1)
        elems = [self._main(c, offset) for c in cols]
        kind = elems[0].kind if elems else "base"
        return Expr(self.backend, kind, [e.val for e in elems])

    def aux_many(self, cols, offset: int = 0) -> Expr:
        cols = list(cols)
        if isinstance(self.backend, DegreeBackend):
            return Expr(self.backend, "base", 1)
        vals = [self._aux(c, offset).val for c in cols]
        return Expr(self.backend, "ext", vals)

    def public_many(self, idxs) -> Expr:
        idxs = list(idxs)
        if isinstance(self.backend, DegreeBackend):
            return Expr(self.backend, "base", 0)
        vals = [self._publics[i].val for i in idxs]
        return Expr(self.backend, "base", vals)

    def aux_value_many(self, idxs) -> Expr:
        idxs = list(idxs)
        if isinstance(self.backend, DegreeBackend):
            return Expr(self.backend, "base", 0)
        vals = [self._aux_values[i].val for i in idxs]
        return Expr(self.backend, "ext", vals)

    def periodic(self, i: int) -> Expr:
        return self._periodic[i]

    def public(self, i: int) -> Expr:
        return self._publics[i]

    def rand(self, i: int) -> Expr:
        return self._randomness[i]

    def aux_value(self, i: int) -> Expr:
        return self._aux_values[i]

    def const(self, c: int) -> Expr:
        return Expr(self.backend, "base", self.backend.const(c))

    def ext_const(self, c) -> Expr:
        if isinstance(self.backend, DegreeBackend):
            return Expr(self.backend, "base", 0)
        return Expr(self.backend, "ext", (c[0] % gl.P, c[1] % gl.P))

    # --- selectors ---
    def is_first_row(self) -> Expr:
        return self._selectors[0]

    def is_last_row(self) -> Expr:
        return self._selectors[1]

    def is_transition(self) -> Expr:
        return self._selectors[2]

    # --- constraint sinks ---
    def _fold(self, e: Expr) -> None:
        self.num_constraints += 1
        if isinstance(self.backend, DegreeBackend):
            self.acc = e.val if self.acc is None else max(self.acc, e.val)
            return
        if self.acc is None:
            self.acc = e
        else:
            self.acc = self.acc * self._alpha + e

    def assert_zero(self, e: Expr, label: str | None = None) -> None:
        """Constraint holding on every row."""
        self._tag(label)
        self._fold(e)

    def assert_zero_first_row(self, e: Expr, label: str | None = None) -> None:
        self._tag(label)
        self._fold(e * self.is_first_row())

    def assert_zero_last_row(self, e: Expr, label: str | None = None) -> None:
        self._tag(label)
        self._fold(e * self.is_last_row())

    def assert_transition(self, e: Expr, label: str | None = None) -> None:
        """Constraint holding on every row but the last."""
        self._tag(label)
        self._fold(e * self.is_transition())

    def _tag(self, label: str | None) -> None:
        """Debug folders override to record the label of the next
        constraint; production folders ignore labels."""

    # --- stacked (family) sinks ---
    def _fold_many(self, e: Expr) -> None:
        """Fold a stacked family of G constraints in one step:
        ``acc ← acc·α^G + Σ_g α^{G−1−g}·c_g`` — equal to folding them one by
        one."""
        if isinstance(self.backend, DegreeBackend):
            self.num_constraints += 1
            self.acc = e.val if self.acc is None else max(self.acc, e.val)
            return
        vals = e.val if isinstance(e.val, list) else [e.val]
        for v in vals:
            self._fold(Expr(self.backend, e.kind, v))

    def stack(self, exprs) -> Expr:
        """Stack same-kind Exprs into one family Expr with a leading group
        axis, for use with ``assert_*_many``."""
        exprs = list(exprs)
        kind = "ext" if any(e.kind == "ext" for e in exprs) else "base"
        if isinstance(self.backend, DegreeBackend):
            return Expr(self.backend, "base", max(e.val for e in exprs))
        vals = [
            e.val if e.kind == kind or kind == "base" else self.backend._ext(e.val, e.kind)
            for e in exprs
        ]
        return Expr(self.backend, kind, vals)

    def assert_zero_many(self, e: Expr, label: str | None = None) -> None:
        self._tag(label)
        self._fold_many(e)

    def assert_zero_first_row_many(self, e: Expr, label: str | None = None) -> None:
        self._tag(label)
        self._fold_many(e * self.is_first_row())

    def assert_zero_last_row_many(self, e: Expr, label: str | None = None) -> None:
        self._tag(label)
        self._fold_many(e * self.is_last_row())

    def assert_transition_many(self, e: Expr, label: str | None = None) -> None:
        self._tag(label)
        self._fold_many(e * self.is_transition())


# ---------------------------------------------------------------------------
# Air / MultiAir
# ---------------------------------------------------------------------------


class Air:
    """One AIR instance: main width, optional aux (LogUp) columns, periodic
    columns, and an ``eval`` over a :class:`Folder`. Window of 2 rows
    (offset ∈ {0, 1}); reference ``LiftedAir`` (crates/lifted-air/src/air.rs:48)."""

    width: int = 0
    aux_width: int = 0
    preprocessed_width: int = 0
    num_randomness: int = 0
    num_aux_values: int = 0
    num_public_values: int = 0
    periodic_columns: Sequence[Sequence[int]] = ()

    def __hash__(self):
        return hash(type(self))

    def __eq__(self, other):
        return type(other) is type(self)

    def eval(self, f: Folder) -> None:
        raise NotImplementedError

    def preprocessed_trace(self):
        return None

    def constraint_degree(self) -> int:
        """Max degree multiple via the degree backend."""
        backend = DegreeBackend()
        one = Expr(backend, "base", 1)
        zero = Expr(backend, "base", 0)
        f = Folder(
            backend,
            main_fn=lambda c, o=0: Expr(backend, "base", 1),
            aux_fn=lambda c, o=0: Expr(backend, "base", 1),
            preprocessed_fn=lambda c, o=0: Expr(backend, "base", 1),
            # a period-p column counts as a full trace-degree factor
            periodic=[one] * len(self.periodic_columns),
            publics=[zero] * self.num_public_values,
            randomness=[zero] * self.num_randomness,
            aux_values=[zero] * self.num_aux_values,
            selectors=(one, one, Expr(backend, "base", 0)),
            alpha=zero,
        )
        self.eval(f)
        return int(f.acc or 1)


class MultiAir:
    """A set of AIRs proven together. ``eval_external`` checks cross-AIR
    assertions over the per-AIR aux values; all entries must be zero."""

    def __init__(self, airs: Sequence[Air]):
        self.airs = list(airs)

    def num_public_values(self) -> int:
        return max((a.num_public_values for a in self.airs), default=0)

    def observe(self, challenger, publics, aux_inputs) -> None:
        challenger.observe_slice(publics)
        challenger.observe_slice(aux_inputs)

    def eval_external(self, randomness, aux_values, log_heights) -> list:
        return []
