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

Every Fiat-Shamir value stays a device tensor threaded from the
:class:`~miden_tpu_torch.transcript.device_challenger.DeviceChallenger`.
Extension values are int64 tensors with a trailing dimension of 2.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

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


def coset_points(log_size: int, shift: int, device) -> torch.Tensor:
    """Natural-order points of the coset shift·K, cached per (size, shift)."""
    key = (log_size, shift % gl.P, str(device))
    if key not in _POINTS_CACHE:
        w = gl.two_adic_generator(log_size)
        _POINTS_CACHE[key] = F.powers(w, 1 << log_size, shift=shift, device=device)
    return _POINTS_CACHE[key]


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


def _weighted_eval_dev(weights, scale, matrix):
    """scale · Σ_i weights_i·f_col(x_i) per column: (w, 2)."""
    m, w = matrix.shape
    sums = None
    for r0 in range(0, m, ROW_CHUNK):
        part = F.ext_sum_axis0(
            F.ext_mul_base(weights[r0 : r0 + ROW_CHUNK, None, :], matrix[r0 : r0 + ROW_CHUNK])
        )
        sums = part if sums is None else F.ext_add(sums, part)
    return F.ext_mul(scale, sums)


@dataclass
class DeepClaims:
    """``evals[point][tree]``: (K_tree, 2) aligned column claims of all the
    tree's matrices (zero pads included); ``aligned_widths[tree][matrix]``."""

    evals: list
    aligned_widths: list


def compute_deep_claims(trees: list, zs: list) -> DeepClaims:
    """Evaluate all committed columns of all trees at each opening point. A
    matrix of height h in a tree of height H is evaluated at ``z^{H/h}``."""
    max_h = max(t.height for t in trees)
    out = []
    aligned = [[lmcs.aligned_width(m.shape[1]) for m in t.matrices] for t in trees]
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
                if log_m not in factors:
                    shift = gl.canonical_lde_shift(log_m)
                    pts = coset_points(log_m, shift, matrix.device)
                    log_lift = (max_h // h).bit_length() - 1
                    factors[log_m] = _bary_weights_dev(log_m, shift, log_lift, z, pts)
                weights, scale = factors[log_m]
                vals = _weighted_eval_dev(weights, scale, matrix)
                aw = lmcs.aligned_width(w)
                if aw > w:
                    vals = torch.nn.functional.pad(vals, (0, 0, 0, aw - w))
                parts.append(vals)
            per_tree.append(
                torch.cat(parts) if parts else torch.zeros((0, 2), dtype=torch.int64, device=z.device)
            )
        out.append(per_tree)
    return DeepClaims(evals=out, aligned_widths=aligned)


# ---------------------------------------------------------------------------
# DEEP quotient
# ---------------------------------------------------------------------------


def deep_compose(domain: LiftedDomain, trees: list, claims: DeepClaims, zs: list, alpha, beta):
    """DEEP quotient evaluations over the max LDE domain (natural order):
    ``Q(x) = Σ_j β^j·(f_red(z_j) − f_red(x))/(z_j − x)``. Returns (N, 2)."""
    device = alpha.device
    total_w = sum(sum(aws) for aws in claims.aligned_widths)
    desc = F.ext_powers(alpha, total_w).flip(0)  # position i gets α^{W−1−i}

    f_red_zs = [
        F.ext_sum_axis0(F.ext_mul(desc, torch.cat(per_tree))) for per_tree in claims.evals
    ]

    big_n = domain.lde_height
    f_red = None
    off = 0
    for tree, aws in zip(trees, claims.aligned_widths):
        for matrix, aw in zip(tree.matrices, aws):
            h, w = matrix.shape
            if w:
                crow = desc[off : off + w][None]  # (1, w, 2)
                part = torch.cat([
                    sum_axis1(F.ext_mul_base(crow, matrix[r0 : r0 + ROW_CHUNK]))
                    for r0 in range(0, h, ROW_CHUNK)
                ])  # (h, 2)
                part = part.repeat(big_n // h, 1)
                f_red = part if f_red is None else F.ext_add(f_red, part)
            off += aw

    pts = coset_points(domain.log_lde_height, domain.lde_shift, device)
    bpows = F.ext_powers(beta, len(zs))
    acc = None
    for j, z in enumerate(zs):
        inv_den = F.ext_inv(F.ext_sub(z, F.ext_from_base(pts)))
        term = F.ext_mul(F.ext_sub(f_red_zs[j], f_red), inv_den)
        if j > 0:
            term = F.ext_mul(term, bpows[j])
        acc = term if acc is None else F.ext_add(acc, term)
    return acc


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


def fri_num_rounds(params: PcsParams, domain: LiftedDomain) -> int:
    size = domain.lde_height
    final_domain_size = params.final_poly_degree << params.log_blowup
    rounds = 0
    while size > final_domain_size:
        size >>= params.log_folding_arity
        rounds += 1
    return rounds


def fri_round(params: PcsParams, cur, x_inv, channel, last: bool):
    """One FRI round: reshape → commit → grind → β → fold (+ x_inv step).
    Returns (tree, folded, next_x_inv)."""
    log_arity = params.log_folding_arity
    arity = 1 << log_arity
    n_rows = cur.shape[0] >> log_arity
    with span("FRI round commit", rows=n_rows):
        mat = cur.reshape(arity, n_rows, 2).transpose(0, 1).contiguous()  # (rows, arity, 2)
        tree = lmcs.build_tree([mat.reshape(n_rows, 2 * arity)], hash=params.lmcs_hash())
    channel.send_commitment(tree.root_dev())
    channel.grind(params.folding_pow_bits)
    beta = channel.sample_ext()
    with span("FRI fold", rows=n_rows):
        folded = _fold_rows_dev(log_arity, mat, x_inv[:n_rows], beta)
    next_x_inv = x_inv
    if not last:
        next_x_inv = F.exp_power_of_2(x_inv[: n_rows >> log_arity], log_arity)
    return tree, folded, next_x_inv


def fri_final(params: PcsParams, domain: LiftedDomain, cur, channel) -> None:
    """Interpolate + truncate the last layer and send the final polynomial."""
    rounds = fri_num_rounds(params, domain)
    cur_shift = gl.exp_power_of_2(domain.lde_shift, params.log_folding_arity * rounds)
    channel.send_ext_slice(_final_poly_dev(params.final_poly_degree, cur, cur_shift))


def fri_commit(params: PcsParams, domain: LiftedDomain, evals, channel) -> list:
    """FRI commit phase (reference pcs/fri/prover.rs:93-242, natural order).
    Returns the LMCS tree of every round."""
    rounds = fri_num_rounds(params, domain)
    x_inv = fri_x_inv_init(params, domain, evals.device)
    trees = []
    cur = evals
    for r in range(rounds):
        tree, cur, x_inv = fri_round(params, cur, x_inv, channel, r == rounds - 1)
        trees.append(tree)
    fri_final(params, domain, cur, channel)
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
        fri_trees = fri_commit(params, domain, deep_evals, channel)
    with span("query grind", bits=params.query_pow_bits):
        channel.grind(params.query_pow_bits)
    idx = torch.stack([channel.sample() for _ in range(params.num_queries)])
    return fri_trees, idx
