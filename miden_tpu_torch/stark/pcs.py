"""PCS prover: DEEP quotient + FRI commit/query phases on device.

The conventions of ``miden_tpu.stark.pcs`` (reference
crates/lifted-stark/src/pcs/):

- committed matrices hold LDE evaluations in natural order over their own
  canonical coset ``s_m·K_m``;
- OOD evaluation of every committed column is barycentric over its own
  domain: ``f(z) = (z^m − s^m)/(m·s^m) · Σ_i f(x_i)·x_i/(z − x_i)``;
- the DEEP quotient combines all columns with α (highest power on the first
  column) and the points with β:
  ``Q(X) = Σ_j β^j·(f_red(z_j) − f_red(X))/(z_j − X)``, shorter matrices
  lifted by cyclic repetition;
- FRI round r views natural-order evals E as (size/arity, arity): row k
  holds ``[E[k + j·size/arity] for j]``, the coset ``x_k·⟨μ⟩``; folding is a
  size-arity inverse DFT + Horner at ``β/x_k``.

Over a mesh (trees of :func:`~..dist.lmcs_dist.build_tree_sharded`) every
step keeps the max LDE domain's rows sharded: the OOD claims sum each
rank's partial sums (:func:`~..dist.mesh.sum_partials`), the DEEP quotient
is this rank's block, and each FRI round transposes its blocks between the
ranks (:func:`~..dist.mesh.all_to_all_rows`) until a round's matrix holds
fewer than ``FRI_MIN_SHARD_ROWS`` rows a rank; that layer is gathered and
the rest runs whole.

Every Fiat-Shamir value stays a device tensor threaded from the
:class:`~miden_tpu_torch.transcript.device_challenger.DeviceChallenger`.
Extension values are int64 tensors with a trailing dimension of 2.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..dist.lmcs_dist import build_tree_sharded
from ..dist.mesh import RowShard, all_to_all_rows, block_rows, gather_rows, sum_partials
from ..field import gl
from ..field import goldilocks as F
from ..merkle import lmcs
from ..ntt import ntt
from ..utils.tracing import span
from .domains import LiftedDomain
from .params import PcsParams

_POINTS_CACHE: dict = {}

#: rows per slice when a column reduction would otherwise materialize a
#: whole (m, w, 2) extension product at once
ROW_CHUNK = 1 << 18

#: a FRI round runs sharded while its (rows, arity) matrix holds at least
#: this many rows a rank; the first layer below it is gathered
FRI_MIN_SHARD_ROWS = 8


def coset_points(log_size: int, shift: int, device, start: int = 0, count: int | None = None) -> torch.Tensor:
    """Natural-order points ``[start, start + count)`` (all by default) of
    the coset shift·K, cached per (size, shift, slice): a rank's block is
    made without the whole table."""
    count = (1 << log_size) - start if count is None else count
    key = (log_size, shift % gl.P, str(device), start, count)
    if key not in _POINTS_CACHE:
        w = gl.two_adic_generator(log_size)
        first = gl.mul(shift % gl.P, pow(w, start, gl.P))
        _POINTS_CACHE[key] = F.powers(w, count, shift=first, device=device)
    return _POINTS_CACHE[key]


def _tree_mesh(trees: list):
    """The mesh the trees are sharded over, or None."""
    return next((t.mesh for t in trees if t.mesh is not None), None)


def sum_axis1(x: torch.Tensor) -> torch.Tensor:
    return F.sum_axis0(x.movedim(1, 0))


# ---------------------------------------------------------------------------
# OOD evaluation (barycentric)
# ---------------------------------------------------------------------------


def _bary_weights_dev(log_m: int, shift: int, log_lift: int, z, pts):
    """Barycentric factors for one (height, lift, point): the weight column
    ``x_i/(z_l − x_i)`` (m, 2) and the scalar ``(z_l^m − s^m)/(m·s^m)`` (2,)."""
    z_l = F.ext_exp_power_of_2(z, log_lift)
    m = 1 << log_m
    weights = F.ext_mul_base(F.ext_inv(F.ext_sub(z_l, F.ext_from_base(pts))), pts)
    sm = gl.exp_power_of_2(shift % gl.P, log_m)
    c = gl.inv(gl.mul(m % gl.P, sm))
    zm = F.ext_exp_power_of_2(z_l, log_m)
    scale = F.ext_mul_base(
        F.ext_sub(zm, F.ext_const((sm, 0), device=z.device)), F.const(c, device=z.device)
    )
    return weights, scale


def _weighted_sums_dev(weights, matrix):
    """Σ_i weights_i·f_col(x_i) per column: (w, 2)."""
    m, w = matrix.shape
    sums = None
    for r0 in range(0, m, ROW_CHUNK):
        part = F.ext_sum_axis0(
            F.ext_mul_base(weights[r0 : r0 + ROW_CHUNK, None, :], matrix[r0 : r0 + ROW_CHUNK])
        )
        sums = part if sums is None else F.ext_add(sums, part)
    return sums


@dataclass
class DeepClaims:
    """``evals[point][tree]``: (K_tree, 2) aligned column claims of all the
    tree's matrices (zero pads included); ``aligned_widths[tree][matrix]``."""

    evals: list
    aligned_widths: list


def compute_deep_claims(trees: list, zs: list) -> DeepClaims:
    """Evaluate all committed columns of all trees at each opening point. A
    matrix of height h in a tree of height H is evaluated at ``z^{H/h}``.

    A row-sharded matrix is summed over this rank's rows (its slice of the
    coset points); the partial sums of every such matrix and point go
    through one :func:`~..dist.mesh.sum_partials`, so the claims are one
    device's exactly (field addition is exact in any order)."""
    max_h = max(t.height for t in trees)
    mesh = _tree_mesh(trees)
    aligned = [[lmcs.aligned_width(m.shape[1]) for m in t.matrices] for t in trees]
    terms = []  # per point, per tree: [sums (w, 2), scale, aligned width]
    partials = []  # the sums of the row-sharded matrices, in order
    for z in zs:
        per_tree = []
        factors: dict = {}  # matrices of one height share the barycentric factors
        for tree in trees:
            parts = []
            for matrix, h in zip(tree.matrices, tree.heights):
                w = matrix.shape[1]
                if w == 0:
                    continue
                log_m = h.bit_length() - 1
                sharded = isinstance(matrix, RowShard)
                if (log_m, sharded) not in factors:
                    shift = gl.canonical_lde_shift(log_m)
                    if sharded:
                        rows = matrix.local.shape[0]
                        pts = coset_points(log_m, shift, z.device, mesh.rank * rows, rows)
                    else:
                        pts = coset_points(log_m, shift, matrix.device)
                    log_lift = (max_h // h).bit_length() - 1
                    factors[(log_m, sharded)] = _bary_weights_dev(log_m, shift, log_lift, z, pts)
                weights, scale = factors[(log_m, sharded)]
                sums = _weighted_sums_dev(weights, matrix.local if sharded else matrix)
                if sharded:
                    partials.append(sums)
                parts.append([sums, scale, lmcs.aligned_width(w), sharded])
            per_tree.append(parts)
        terms.append(per_tree)
    if partials:
        total = sum_partials(torch.cat(partials), mesh)
        off = 0
        for part in (p for per_tree in terms for parts in per_tree for p in parts if p[3]):
            w = part[0].shape[0]
            part[0] = total[off : off + w]
            off += w
    out = []
    for z, per_tree in zip(zs, terms):
        cols = []
        for parts in per_tree:
            vals = []
            for sums, scale, aw, _ in parts:
                v = F.ext_mul(scale, sums)
                if aw > v.shape[0]:
                    v = torch.nn.functional.pad(v, (0, 0, 0, aw - v.shape[0]))
                vals.append(v)
            cols.append(torch.cat(vals) if vals else torch.zeros((0, 2), dtype=torch.int64, device=z.device))
        out.append(cols)
    return DeepClaims(evals=out, aligned_widths=aligned)


# ---------------------------------------------------------------------------
# DEEP quotient
# ---------------------------------------------------------------------------


def deep_compose(domain: LiftedDomain, trees: list, claims: DeepClaims, zs: list, alpha, beta):
    """DEEP quotient evaluations over the max LDE domain (natural order):
    ``Q(x) = Σ_j β^j·(f_red(z_j) − f_red(x))/(z_j − x)``. Returns (N, 2);
    over sharded trees this rank's block of it, as a RowShard (a whole
    shorter matrix lifted by its rows ``(k·S + j) mod h``)."""
    device = alpha.device
    mesh = _tree_mesh(trees)
    total_w = sum(sum(aws) for aws in claims.aligned_widths)
    desc = F.ext_powers(alpha, total_w).flip(0)  # position i gets α^{W−1−i}

    f_red_zs = [
        F.ext_sum_axis0(F.ext_mul(desc, torch.cat(per_tree))) for per_tree in claims.evals
    ]

    big_n = domain.lde_height
    rows = big_n if mesh is None else big_n // mesh.size
    start = 0 if mesh is None else mesh.rank * rows

    def reduce(crow, m):
        return torch.cat([
            sum_axis1(F.ext_mul_base(crow, m[r0 : r0 + ROW_CHUNK])) for r0 in range(0, m.shape[0], ROW_CHUNK)
        ])  # (h, 2)

    f_red = None
    off = 0
    for tree, aws in zip(trees, claims.aligned_widths):
        for matrix, aw in zip(tree.matrices, aws):
            h, w = matrix.shape
            if w:
                crow = desc[off : off + w][None]  # (1, w, 2)
                if mesh is not None and (isinstance(matrix, RowShard) or h >= rows):
                    part = reduce(crow, block_rows(matrix, big_n, mesh))
                else:
                    part = reduce(crow, matrix).repeat(rows // h, 1)
                f_red = part if f_red is None else F.ext_add(f_red, part)
            off += aw

    pts = coset_points(domain.log_lde_height, domain.lde_shift, device, start, rows)
    bpows = F.ext_powers(beta, len(zs))
    acc = None
    for j, z in enumerate(zs):
        inv_den = F.ext_inv(F.ext_sub(z, F.ext_from_base(pts)))
        term = F.ext_mul(F.ext_sub(f_red_zs[j], f_red), inv_den)
        if j > 0:
            term = F.ext_mul(term, bpows[j])
        acc = term if acc is None else F.ext_add(acc, term)
    return acc if mesh is None else RowShard(acc, big_n)


# ---------------------------------------------------------------------------
# FRI
# ---------------------------------------------------------------------------


def _fold_rows_dev(log_arity: int, mat, x_inv, beta):
    """Fold each row's coset evals: size-arity inverse DFT + Horner at β/x_k.
    mat: (rows, arity, 2) with column j = f(x_k·μ^j); x_inv: (rows,).
    Returns (rows, 2): g(x_k^arity)."""
    arity = 1 << log_arity
    mu_inv = gl.inv(gl.two_adic_generator(log_arity))
    device = mat.device
    cs = []
    for t in range(arity):
        acc = None
        for j in range(arity):
            w = pow(mu_inv, (j * t) % arity, gl.P)
            col = mat[:, j]
            term = col if w == 1 else F.mul(col, F.const(w, device=device))
            acc = term if acc is None else F.ext_add(acc, term)
        cs.append(acc)
    x = F.ext_mul_base(beta, x_inv)  # (rows, 2)
    acc = cs[-1]
    for t in reversed(range(arity - 1)):
        acc = F.ext_add(F.ext_mul(acc, x), cs[t])
    return F.mul(acc, F.const(gl.inv(arity), device=device))


def _final_poly_dev(final_deg: int, cur, shift: int):
    """Interpolate the last FRI layer over its coset, truncate to the degree
    bound, return **descending** coefficients (final_deg, 2)."""
    coeffs_br = ntt.coset_interpolate_bitrev(cur, shift)  # the (size, 2) ext as 2 columns
    return ntt.bitrev_perm(coeffs_br)[:final_deg].flip(0)


def fri_x_inv_init(params: PcsParams, domain: LiftedDomain, device):
    """x_inv[k] = 1/(s·ω^k) over the first size/arity rows."""
    n_rows = domain.lde_height >> params.log_folding_arity
    return F.powers(
        gl.inv(gl.two_adic_generator(domain.log_lde_height)),
        n_rows,
        shift=gl.inv(domain.lde_shift),
        device=device,
    )


def fri_x_inv_rows(params: PcsParams, domain: LiftedDomain, r: int, start: int, count: int, device):
    """Round ``r``'s x_inv at rows ``[start, start + count)``:
    ``1/(s_r·ω_r^k)`` with ``s_r = s^{arity^r}`` and ``ω_r`` the generator
    of the round's domain (what :func:`fri_round` carries from round to
    round, made for one rank's block or a gathered layer)."""
    bits = params.log_folding_arity * r
    w_inv = gl.inv(gl.two_adic_generator(domain.log_lde_height - bits))
    s_inv = gl.inv(gl.exp_power_of_2(domain.lde_shift, bits))
    return F.powers(w_inv, count, shift=gl.mul(s_inv, pow(w_inv, start, gl.P)), device=device)


def fri_num_rounds(params: PcsParams, domain: LiftedDomain) -> int:
    size = domain.lde_height
    final_domain_size = params.final_poly_degree << params.log_blowup
    rounds = 0
    while size > final_domain_size:
        size >>= params.log_folding_arity
        rounds += 1
    return rounds


def fri_round(params: PcsParams, cur, x_inv, channel, last: bool, mesh=None):
    """One FRI round: reshape → commit → grind → β → fold (+ x_inv step).
    Returns (tree, folded, next_x_inv). A RowShard ``cur`` of ``mesh`` is
    transposed between the ranks (each gets its block of the round's rows),
    committed as a sharded tree and folded on this rank's rows with its
    slice ``x_inv``; the folded layer is a RowShard and no next x_inv is
    made (:func:`fri_x_inv_rows` makes the next round's slice)."""
    log_arity = params.log_folding_arity
    arity = 1 << log_arity
    n_rows = cur.shape[0] >> log_arity
    with span("FRI round commit", rows=n_rows):
        if isinstance(cur, RowShard):
            mat = all_to_all_rows(cur, arity, mesh)  # (rows of this rank, arity, 2)
            tree = build_tree_sharded([RowShard(mat.reshape(mat.shape[0], 2 * arity), n_rows)], mesh)
        else:
            mat = cur.reshape(arity, n_rows, 2).transpose(0, 1).contiguous()  # (rows, arity, 2)
            tree = lmcs.build_tree([mat.reshape(n_rows, 2 * arity)], hash=params.lmcs_hash())
    channel.send_commitment(tree.root_dev())
    channel.grind(params.folding_pow_bits)
    beta = channel.sample_ext()
    with span("FRI fold", rows=n_rows):
        folded = _fold_rows_dev(log_arity, mat, x_inv[: mat.shape[0]], beta)
    if isinstance(cur, RowShard):
        return tree, RowShard(folded, n_rows), None
    next_x_inv = x_inv
    if not last:
        next_x_inv = F.exp_power_of_2(x_inv[: n_rows >> log_arity], log_arity)
    return tree, folded, next_x_inv


def fri_final(params: PcsParams, domain: LiftedDomain, cur, channel) -> None:
    """Interpolate + truncate the last layer and send the final polynomial."""
    rounds = fri_num_rounds(params, domain)
    cur_shift = gl.exp_power_of_2(domain.lde_shift, params.log_folding_arity * rounds)
    channel.send_ext_slice(_final_poly_dev(params.final_poly_degree, cur, cur_shift))


def fri_commit(params: PcsParams, domain: LiftedDomain, evals, channel, mesh=None) -> list:
    """FRI commit phase (reference pcs/fri/prover.rs:93-242, natural order).
    Returns the LMCS tree of every round. A RowShard ``evals`` of ``mesh``
    folds sharded while a round's matrix holds ``FRI_MIN_SHARD_ROWS`` rows a
    rank or more; the first layer below that is gathered (as is the last
    layer, for :func:`fri_final`)."""
    rounds = fri_num_rounds(params, domain)
    device = (evals.local if isinstance(evals, RowShard) else evals).device
    x_inv = None
    trees = []
    cur = evals
    for r in range(rounds):
        if isinstance(cur, RowShard):
            n_rows = cur.rows >> params.log_folding_arity
            if n_rows // mesh.size >= FRI_MIN_SHARD_ROWS:
                s = n_rows // mesh.size
                x_inv = fri_x_inv_rows(params, domain, r, mesh.rank * s, s, device)
            else:
                cur = gather_rows(cur, mesh)
                x_inv = fri_x_inv_rows(params, domain, r, 0, n_rows, device)
        elif x_inv is None:
            x_inv = fri_x_inv_init(params, domain, device)
        tree, cur, x_inv = fri_round(params, cur, x_inv, channel, r == rounds - 1, mesh)
        trees.append(tree)
    fri_final(params, domain, gather_rows(cur, mesh), channel)
    return trees


def open_with_channel(params: PcsParams, domain: LiftedDomain, trees: list, zs: list, channel):
    """PCS opening through query-index sampling (reference
    pcs/prover.rs:35-105): DEEP → FRI → PoW → sample indices. Returns
    (fri_trees, (q,) device tensor of raw index samples)."""
    with span("evaluate at OOD points"):
        claims = compute_deep_claims(trees, zs)
    for per_tree in claims.evals:
        channel.send_ext_slice(torch.cat(per_tree))
    with span("DEEP grind", bits=params.deep_pow_bits):
        channel.grind(params.deep_pow_bits)
    alpha = channel.sample_ext()
    beta = channel.sample_ext()
    with span("DEEP reduce + assemble"):
        deep_evals = deep_compose(domain, trees, claims, zs, alpha, beta)
    with span("FRI commit phase"):
        fri_trees = fri_commit(params, domain, deep_evals, channel, _tree_mesh(trees))
    with span("query grind", bits=params.query_pow_bits):
        channel.grind(params.query_pow_bits)
    idx = torch.stack([channel.sample() for _ in range(params.num_queries)])
    return fri_trees, idx
