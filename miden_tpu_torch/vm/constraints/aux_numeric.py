"""Generic LogUp aux builder: evaluates an AIR's fraction-column spec with
the very same spec the constraints consume, so the prover and the
constraint system cannot drift.

Aux layout convention (all three VM AIRs): column 0 is the accumulator,
columns 1.. are the fraction columns; acc[0] = seed (1/d_seed or 0),
acc[r+1] = acc[r] + Σ fractions(row r); the final value is returned as
the committed aux value when the AIR declares one.

:func:`build_device_aux` is the prover's builder (torch tensors on the
trace's device, every row at once); :func:`build_numeric_aux` is the plain
per-row reference with exact Python ints, used by the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ...field import gl
from ...field import goldilocks as F
from ...stark.air import Expr, Folder, ScalarBackend, VectorBackend
from ...stark.aux import prefix_sum_ext


def build_device_aux(air, main, publics, randomness, columns_fn, seed_fn=None):
    """Evaluates the fraction-column spec ONCE over all rows with the
    vector backend (the spec is backend-generic), inverts every
    denominator in one batch, and builds the accumulator with a prefix scan
    — the analog of the reference's fused accumulator
    (air/src/lookup/aux_builder.rs:36-303).

    ``main`` is the (n, width) int64 trace on the device, ``publics`` the
    (n_pub,) public values there (or a host list) and ``randomness`` holds
    (2,) extension tensors there, as the prover passes them. Returns
    the aux trace (n, 2·(1+k)) — the accumulator first, then the k fraction
    columns, c0 and c1 side by side, row n−1 of every fraction column zero —
    and the aux values (num_aux_values, 2)."""
    device = main.device
    n = main.shape[0]
    be = VectorBackend((n,), device)

    main_t = main.T.contiguous()  # columns as contiguous rows
    main_next = torch.roll(main_t, -1, dims=1)

    def main_fn(c, offset=0):
        return Expr(be, "base", (main_next if offset else main_t)[c])

    periodic = [Expr(be, "base", F.table(p, device).repeat(n // len(p))) for p in air.periodic_columns]
    if not isinstance(publics, torch.Tensor):
        publics = F.to_torch([int(v) % gl.P for v in publics], device)
    folder = Folder(
        be,
        main_fn=main_fn,
        periodic=periodic,
        publics=[Expr(be, "base", publics[i]) for i in range(publics.shape[0])],
        randomness=[Expr(be, "ext", r) for r in randomness],
        selectors=(Expr(be, "base", be.const(0)), Expr(be, "base", be.const(0)),
                   Expr(be, "base", be.const(1))),
    )

    def as_ext(e):
        v = e.val if e.kind == "ext" else F.ext_from_base(e.val)
        return v.expand(n, 2)

    cols = columns_fn(folder)
    k = len(cols)
    if k:
        num = torch.stack([as_ext(v) for v, _ in cols], dim=1)  # (n, k, 2)
        den = torch.stack([as_ext(u) for _, u in cols], dim=1)
        # row n−1 has no transition: its fractions are zero, and a unit
        # denominator there keeps the batch inverse free of that row's value
        den[n - 1] = F.ext_const((1, 0), device=device)
        fracs = F.ext_mul(num, F.ext_inv(den))
        fracs[n - 1] = 0
        rowsum = fracs[:, 0]
        for i in range(1, k):
            rowsum = F.ext_add(rowsum, fracs[:, i])
    else:
        fracs = torch.zeros((n, 0, 2), dtype=torch.int64, device=device)
        rowsum = torch.zeros((n, 2), dtype=torch.int64, device=device)

    if seed_fn is not None:
        seed = F.ext_inv(as_ext(seed_fn(folder))[0])  # row-0 value
    else:
        seed = torch.zeros(2, dtype=torch.int64, device=device)

    # acc[r] = seed + Σ_{r' < r} Σ_i fracs[r', i]
    inc = prefix_sum_ext(rowsum)  # inclusive prefix
    acc = F.ext_add(torch.cat([torch.zeros((1, 2), dtype=torch.int64, device=device), inc[: n - 1]]), seed)
    aux = torch.cat([acc[:, None, :], fracs], dim=1).reshape(n, 2 * (1 + k))
    if air.num_aux_values:
        return aux, F.ext_add(inc[n - 1], seed)[None]
    return aux, torch.zeros((0, 2), dtype=torch.int64, device=device)


def build_numeric_aux(air, main, publics, randomness, columns_fn, seed_fn=None):
    """Plain per-row reference of :func:`build_device_aux` over a numpy u64
    ``main``. Returns (aux (n, 1+k, 2) u64, aux_values) where k = number of
    fraction columns produced by ``columns_fn(f)``."""
    n = main.shape[0]
    be = ScalarBackend()

    def base(v):
        return Expr(be, "base", int(v) % gl.P)

    def ext(pair):
        return Expr(be, "ext", (int(pair[0]) % gl.P, int(pair[1]) % gl.P))

    pubs = [base(v) for v in publics]
    rands = [ext(r) for r in randomness]
    periodic_patterns = [list(p) for p in air.periodic_columns]

    def as_ext(val):
        return val if isinstance(val, tuple) else (val % gl.P, 0)

    def folder(r, rn):
        return Folder(
            be,
            main_fn=lambda c, o=0: base(main[rn if o else r, c]),
            periodic=[base(p[r % len(p)]) for p in periodic_patterns],
            publics=pubs,
            randomness=rands,
            selectors=(base(0), base(0), base(1)),
        )

    k = None
    fracs = None
    for r in range(n - 1):
        cols = columns_fn(folder(r, r + 1))
        if fracs is None:
            k = len(cols)
            fracs = np.zeros((n, k, 2), dtype=np.uint64)
        for i, (V, U) in enumerate(cols):
            v = as_ext(V.val)
            u = as_ext(U.val)
            fracs[r, i] = gl.ext_mul(v, gl.ext_inv(u))
    if fracs is None:
        k = 0
        fracs = np.zeros((n, 0, 2), dtype=np.uint64)

    acc = (0, 0)
    if seed_fn is not None:
        f0 = folder(0, 1 % n)
        acc = gl.ext_inv(as_ext(seed_fn(f0).val))
    aux = np.zeros((n, 1 + k, 2), dtype=np.uint64)
    for r in range(n):
        aux[r, 0] = acc
        aux[r, 1:] = fracs[r]
        for i in range(k):
            acc = gl.ext_add(acc, (int(fracs[r, i, 0]), int(fracs[r, i, 1])))
    aux_values = [acc] if air.num_aux_values else []
    return aux, aux_values
