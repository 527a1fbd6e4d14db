"""Full-trace constraint checker for AIR development.

Mirrors `check_constraints` (crates/lifted-stark/src/debug.rs): evaluates
every constraint of an :class:`Air` at every row pair of a concrete trace
with exact scalar arithmetic, reporting the (row, label) of each
violation instead of an α-folded aggregate. Test/debug only — the prover
evaluates the same ``Air.eval`` through the vector backend.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ..field import gl
from .air import Air, Expr, Folder, ScalarBackend


@dataclass
class Violation:
    row: int
    index: int
    label: str
    value: object

    def __repr__(self) -> str:
        return f"row {self.row}: [{self.index}] {self.label} = {self.value}"


class _CheckFolder(Folder):
    """Scalar folder that checks each constraint for zero instead of
    α-folding."""

    def __init__(self, row: int, sink: list, **kw):
        super().__init__(ScalarBackend(), alpha=None, **kw)
        self._row = row
        self._sink = sink
        self._label = None
        self._index = 0

    def _tag(self, label):
        self._label = label

    def _fold(self, e: Expr) -> None:
        vals = e.val if isinstance(e.val, list) else [e.val]
        for v in vals:
            bad = any(x for x in v) if isinstance(v, tuple) else v != 0
            if bad:
                self._sink.append(
                    Violation(self._row, self._index, self._label or "?", v)
                )
            self._index += 1
        self._label = None

    _fold_many = _fold


def check_air(
    air: Air,
    main: np.ndarray,
    aux: np.ndarray | None = None,
    preprocessed: np.ndarray | None = None,
    publics=(),
    randomness=(),
    aux_values=(),
    max_violations: int = 20,
) -> list[Violation]:
    """Evaluates all constraints of `air` on a concrete (n, width) u64 main
    trace (+ optional (n, aux_width, 2) aux trace), returning violations.

    Selector semantics match the prover: first/last-row constraints apply
    only at those rows; transition constraints apply to every row pair
    (r, r+1) with r < n-1. The window at the last row wraps to row 0 with
    is_transition = 0 (cyclic domain, lifted-air window convention).
    """
    n = main.shape[0]
    violations: list[Violation] = []
    be = ScalarBackend()

    def base(v) -> Expr:
        return Expr(be, "base", int(v) % gl.P)

    def ext(c0, c1) -> Expr:
        return Expr(be, "ext", (int(c0) % gl.P, int(c1) % gl.P))

    pubs = [base(v) for v in publics]
    rands = [ext(*r) for r in randomness]
    auxv = [ext(*v) for v in aux_values]

    periodic_cols = [list(pc) for pc in air.periodic_columns]
    # a row's violations depend only on its window: the rows r and r+1 it
    # reads, its periodic values and its selectors. Rows whose window
    # repeats (a chiplet's padding) are evaluated once.
    seen: dict = {}

    for r in range(n):
        if len(violations) >= max_violations:
            break
        rn = (r + 1) % n
        window = hashlib.blake2b(digest_size=16)
        for m in (main, aux, preprocessed):
            if m is not None:
                window.update(np.ascontiguousarray(m[r]).tobytes())
                window.update(np.ascontiguousarray(m[rn]).tobytes())
        window.update(repr(([pc[r % len(pc)] for pc in periodic_cols], r == 0, r == n - 1)).encode())
        key = window.digest()
        if key in seen:
            violations.extend(Violation(r, v.index, v.label, v.value) for v in seen[key])
            continue
        first = len(violations)

        def main_fn(c, o=0, r=r, rn=rn):
            return base(main[rn if o else r, c])

        def aux_fn(c, o=0, r=r, rn=rn):
            row = aux[rn if o else r, c]
            return ext(row[0], row[1])

        def pp_fn(c, o=0, r=r, rn=rn):
            return base(preprocessed[rn if o else r, c])

        f = _CheckFolder(
            r,
            violations,
            main_fn=main_fn,
            aux_fn=aux_fn if aux is not None else None,
            preprocessed_fn=pp_fn if preprocessed is not None else None,
            periodic=[
                base(pc[r % len(pc)]) for pc in periodic_cols
            ],
            publics=pubs,
            randomness=rands,
            aux_values=auxv,
            selectors=(
                base(1 if r == 0 else 0),
                base(1 if r == n - 1 else 0),
                base(1 if r < n - 1 else 0),
            ),
        )
        air.eval(f)
        seen[key] = violations[first:]
    return violations
