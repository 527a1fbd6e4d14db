"""Lifted STARK verifier (host-side, exact Python-int arithmetic).

Mirrors ``VerifierInstance::verify`` (crates/lifted-stark/src/verifier/mod.rs:
227-518): rebuild the proof order from the (untrusted) log heights, replay
Fiat-Shamir, receive commitments and aux values, re-derive the OOD constraint
identity with a scalar constraint folder, and run the PCS verification —
DEEP consistency, FRI fold spot-checks, Merkle openings, PoW checks — ending
with the empty-transcript-tail check.

The verifier is deliberately device-free: O(queries · log n) scalar work.
"""

from __future__ import annotations

from . import gl
from . import lmcs
from .transcript import (
    DuplexChallenger,
    TranscriptError,
    VerifierChannel,
)
from .air import Expr, Folder, MultiAir, ScalarBackend
from .domains import LiftedDomain, log_quotient_degree
from .params import PcsParams
from .proof import Proof, Statement, proof_order

PHI = (0, 1)  # extension basis element x (x² = 7)


class VerificationError(ValueError):
    pass


def pattern_coeffs(pattern) -> list:
    """Coefficients of the degree-<p polynomial with h(ω_p^i) = pattern[i]
    (naive O(p²) inverse DFT — p is tiny)."""
    p = len(pattern)
    w_inv = gl.inv(gl.two_adic_generator(p.bit_length() - 1)) if p > 1 else 1
    n_inv = gl.inv(p % gl.P)
    coeffs = []
    for k in range(p):
        acc = 0
        for i in reversed(range(p)):
            acc = (acc * pow(w_inv, k, gl.P) + pattern[i]) % gl.P
        coeffs.append(gl.mul(acc, n_inv))
    return coeffs


def ext_horner(coeffs_desc, x: tuple) -> tuple:
    acc = (0, 0)
    for c in coeffs_desc:
        acc = gl.ext_add(gl.ext_mul(acc, x), c if isinstance(c, tuple) else (c, 0))
    return acc


def _aux_ext(c0: tuple, c1: tuple) -> tuple:
    """Assemble an EF-column value from its two base-column evaluations:
    A(z) = A0(z) + φ·A1(z)."""
    return gl.ext_add(c0, gl.ext_mul(PHI, c1))


def verify(
    params: PcsParams,
    statement: Statement,
    proof: Proof,
    challenger: DuplexChallenger,
    preprocessed_commitment=None,
) -> list:
    """``preprocessed_commitment``: the trusted setup root of the
    preprocessed LDE tree, required exactly when some AIR declares
    preprocessed columns (verifier/mod.rs:101-119); observed into
    Fiat-Shamir before the statement, never read from the proof."""
    airs = statement.multi_air.airs
    hash_cfg = params.lmcs_hash()
    expected_pp = any(a.preprocessed_width > 0 for a in airs)
    if (preprocessed_commitment is not None) != expected_pp:
        raise VerificationError(
            "preprocessed commitment must be supplied exactly when some AIR "
            "declares preprocessed columns"
        )
    log_heights = list(proof.log_heights)
    if len(log_heights) != len(airs):
        raise VerificationError("log_heights count mismatch")
    for lh in log_heights:
        if not (0 <= lh <= gl.TWO_ADICITY - params.log_blowup):
            raise VerificationError("invalid log height")

    order = proof_order(log_heights)
    max_log_h = max(log_heights)
    max_domain = LiftedDomain.canonical(max_log_h, params.log_blowup)
    domains = [max_domain.sub_domain(log_heights[i]) for i in order]
    big_n = max_domain.lde_height
    n_trace = max_domain.trace_height

    log_ds = [log_quotient_degree(airs[i].constraint_degree()) for i in order]
    log_d = max(log_ds)
    d_chunks = 1 << log_d
    if log_d > params.log_blowup:
        raise VerificationError("constraint degree exceeds blowup")

    if preprocessed_commitment is not None:
        challenger.observe_slice([int(v) % gl.P for v in preprocessed_commitment])
    statement.observe(challenger, log_heights)
    ch = VerifierChannel(proof.data, challenger)

    # 1. Main commitment.
    main_root = ch.read_commitment()

    # 2. Randomness, aux commitment, aux values.
    max_rand = max((a.num_randomness for a in airs), default=0)
    randomness = [ch.sample_ext() for _ in range(max_rand)]
    aux_root = ch.read_commitment()
    aux_values = [
        ch.read_ext_slice(airs[i].num_aux_values) for i in order
    ]
    aux_values_inst = [None] * len(airs)
    for k, i in enumerate(order):
        aux_values_inst[i] = aux_values[k]
    assertions = statement.multi_air.eval_external(
        randomness, aux_values_inst, log_heights
    )
    for k, v in enumerate(assertions):
        if tuple(v) != (0, 0):
            raise VerificationError(f"external assertion {k} non-zero")

    # 3. Fold challenges + quotient commitment.
    alpha = ch.sample_ext()
    beta = ch.sample_ext()
    quotient_root = ch.read_commitment()

    # 4. OOD point.
    z = max_domain.sample_ood_point(ch)
    h_gen = max_domain.trace_generator
    z_next = gl.ext_mul_base(z, h_gen)
    zs = [z, z_next]

    # Tree shapes: [preprocessed?, main, aux, quotient]
    # (prover/mod.rs:547-560 group order). The preprocessed committed order
    # is (height, air index) over preprocessed AIRs — heights equal the main
    # trace heights, so it coincides with proof order restricted to them.
    main_widths = [airs[i].width for i in order]
    aux_widths = [2 * airs[i].aux_width for i in order]
    quotient_widths = [2 * d_chunks]
    main_heights = [domains[k].lde_height for k in range(len(order))]
    pp_air_order = [i for i in order if airs[i].preprocessed_width > 0]
    pp_trace_for_air = {i: t for t, i in enumerate(pp_air_order)}
    if preprocessed_commitment is not None:
        pp_widths = [airs[i].preprocessed_width for i in pp_air_order]
        pp_heights = [
            (1 << log_heights[i]) << params.log_blowup for i in pp_air_order
        ]
        tree_widths = [pp_widths, main_widths, aux_widths, quotient_widths]
        tree_heights = [pp_heights, main_heights, main_heights, [big_n]]
        tree_roots = [
            tuple(int(v) % gl.P for v in preprocessed_commitment),
            main_root, aux_root, quotient_root,
        ]
        t_ofs = 1
    else:
        tree_widths = [main_widths, aux_widths, quotient_widths]
        tree_heights = [main_heights, main_heights, [big_n]]
        tree_roots = [main_root, aux_root, quotient_root]
        t_ofs = 0

    # 5. DEEP claims per point (sent in one aligned stream per point).
    claims = []  # claims[point][tree][matrix][aligned_col] -> ext
    for _ in zs:
        per_tree = []
        for widths in tree_widths:
            per_matrix = []
            for w in widths:
                per_matrix.append(ch.read_ext_slice(lmcs.aligned_width(w)))
            per_tree.append(per_matrix)
        claims.append(per_tree)

    ch.check_pow(params.deep_pow_bits)
    alpha_deep = ch.sample_ext()
    beta_deep = ch.sample_ext()

    # 6. FRI commit phase replay.
    log_arity = params.log_folding_arity
    arity = params.arity
    final_domain_size = params.final_poly_degree << params.log_blowup
    fri_roots = []
    fri_betas = []
    size = big_n
    while size > final_domain_size:
        fri_roots.append(ch.read_commitment())
        ch.check_pow(params.folding_pow_bits)
        fri_betas.append(ch.sample_ext())
        size >>= log_arity
    final_poly = ch.read_ext_slice(params.final_poly_degree)  # descending

    # 7. Query sampling.
    ch.check_pow(params.query_pow_bits)
    indices = sorted(
        {ch.sample_bits(max_domain.log_lde_height) for _ in range(params.num_queries)}
    )

    # 8. Open input trees + FRI trees.
    opened = []
    for root, widths, heights in zip(tree_roots, tree_widths, tree_heights):
        max_h = max(heights)
        rows = lmcs.verify_batch(
            root, widths, max_h, [d % max_h for d in indices], ch,
            hash=hash_cfg,
        )
        opened.append((rows, heights))
    fri_opened = []
    size = big_n
    for r, root in enumerate(fri_roots):
        size >>= log_arity
        idx = sorted({d % size for d in indices})
        rows = lmcs.verify_batch(
            root, [2 * arity], size, idx, ch, hash=hash_cfg
        )
        fri_opened.append(rows)

    # ------------------------------------------------------------------
    # OOD constraint identity (scalar folder per AIR, β-Horner accumulate).
    # ------------------------------------------------------------------
    backend = ScalarBackend()

    def claim_ext(point, tree, mat, col) -> tuple:
        return claims[point][tree][mat][col]

    acc_q = None
    for k, i in enumerate(order):
        air = airs[i]
        dom = domains[k]

        def main_fn(col, offset=0, _k=k):
            return Expr(backend, "ext", claim_ext(offset, t_ofs, _k, col))

        def aux_fn(col, offset=0, _k=k):
            v = _aux_ext(
                claim_ext(offset, t_ofs + 1, _k, 2 * col),
                claim_ext(offset, t_ofs + 1, _k, 2 * col + 1),
            )
            return Expr(backend, "ext", v)

        def preprocessed_fn(col, offset=0, _i=i):
            return Expr(
                backend, "ext", claim_ext(offset, 0, pp_trace_for_air[_i], col)
            )

        zl = dom.lift(z)
        periodic = []
        for pat in air.periodic_columns:
            coeffs = pattern_coeffs(list(pat))
            arg = gl.ext_exp_power_of_2(
                zl, dom.log_trace_height - (len(pat).bit_length() - 1)
            )
            periodic.append(
                Expr(backend, "ext", ext_horner(list(reversed(coeffs)), arg))
            )
        sels = dom.selectors_at(z)
        folder = Folder(
            backend,
            main_fn=main_fn,
            aux_fn=aux_fn,
            preprocessed_fn=preprocessed_fn,
            periodic=periodic,
            publics=[Expr(backend, "base", p % gl.P) for p in statement.publics],
            randomness=[
                Expr(backend, "ext", r)
                for r in randomness[: air.num_randomness]
            ],
            aux_values=[Expr(backend, "ext", v) for v in aux_values[k]],
            selectors=(
                Expr(backend, "ext", sels.is_first_row),
                Expr(backend, "ext", sels.is_last_row),
                Expr(backend, "ext", sels.is_transition),
            ),
            alpha=Expr(backend, "ext", alpha),
        )
        air.eval(folder)
        c_val = folder.acc.val
        if folder.acc.kind == "base":
            c_val = (c_val, 0)
        z_h = dom.vanishing_at(zl)
        q_j = gl.ext_mul(c_val, gl.ext_inv(z_h))
        acc_q = (
            q_j if acc_q is None else gl.ext_add(gl.ext_mul(acc_q, beta), q_j)
        )

    # Committed quotient at z: Q(z) = Σ_t (z^N)^t · q_t(z).
    z_pow_n = gl.ext_exp_power_of_2(z, max_domain.log_trace_height)
    q_at_z = (0, 0)
    for t in reversed(range(d_chunks)):
        q_t = _aux_ext(
            claim_ext(0, t_ofs + 2, 0, 2 * t), claim_ext(0, t_ofs + 2, 0, 2 * t + 1)
        )
        q_at_z = gl.ext_add(gl.ext_mul(q_at_z, z_pow_n), q_t)
    if acc_q != q_at_z:
        raise VerificationError("OOD quotient identity failed")

    # ------------------------------------------------------------------
    # DEEP + FRI query checks.
    # ------------------------------------------------------------------
    s_max = max_domain.lde_shift
    w_max = gl.two_adic_generator(max_domain.log_lde_height)

    # f_red(z_j): α-Horner over the full aligned claim stream.
    f_red_z = []
    for per_tree in claims:
        acc = (0, 0)
        for per_matrix in per_tree:
            for vals in per_matrix:
                for v in vals:
                    acc = gl.ext_add(gl.ext_mul(acc, alpha_deep), v)
        f_red_z.append(acc)

    for d in indices:
        x_d = gl.mul(s_max, pow(w_max, d, gl.P))
        # f_red(x_d) over the opened (aligned) rows, same column order.
        acc = (0, 0)
        for (rows, heights), widths in zip(opened, tree_widths):
            max_h = max(heights)
            row_list = rows[d % max_h]
            for m, (row, w, hgt) in enumerate(zip(row_list, widths, heights)):
                vals = [int(v) for v in row]
                # lifted matrices inside a tree: the opened row IS the row at
                # (d % max_h) % hgt == d % hgt since hgt | max_h.
                vals += [0] * (lmcs.aligned_width(w) - len(vals))
                for v in vals:
                    acc = gl.ext_add(
                        gl.ext_mul(acc, alpha_deep), (v % gl.P, 0)
                    )
        f_red_x = acc
        q_val = (0, 0)
        bpow = (1, 0)
        for j, zj in enumerate(zs):
            num = gl.ext_sub(f_red_z[j], f_red_x)
            den = gl.ext_sub(zj, (x_d, 0))
            term = gl.ext_mul(num, gl.ext_inv(den))
            q_val = gl.ext_add(q_val, gl.ext_mul(bpow, term))
            bpow = gl.ext_mul(bpow, beta_deep)

        # FRI fold chain.
        mu = gl.two_adic_generator(log_arity)
        mu_inv = gl.inv(mu)
        cur_val = q_val
        cur_index = d
        cur_size = big_n
        cur_shift = s_max
        cur_gen = w_max
        for r in range(len(fri_roots)):
            rows_count = cur_size >> log_arity
            k_row = cur_index % rows_count
            col = cur_index // rows_count
            row = [int(v) for v in fri_opened[r][k_row][0]]
            y = [
                _aux_ext_pair(row[2 * j], row[2 * j + 1]) for j in range(arity)
            ]
            if y[col] != cur_val:
                raise VerificationError(f"FRI round {r} row/value mismatch")
            # fold: (1/a)·Σ_t (β/x_k)^t·(Σ_j μ^{−jt}·y_j)
            x_k = gl.mul(cur_shift, pow(cur_gen, k_row, gl.P))
            x = gl.ext_mul_base(fri_betas[r], gl.inv(x_k))
            cs = []
            for t in range(arity):
                s_t = (0, 0)
                for j in range(arity):
                    wjt = pow(mu_inv, (j * t) % arity, gl.P)
                    s_t = gl.ext_add(s_t, gl.ext_mul_base(y[j], wjt))
                cs.append(s_t)
            folded = cs[-1]
            for t in reversed(range(arity - 1)):
                folded = gl.ext_add(gl.ext_mul(folded, x), cs[t])
            cur_val = gl.ext_mul_base(folded, gl.inv(arity))
            cur_index = k_row
            cur_size = rows_count
            cur_shift = gl.exp_power_of_2(cur_shift, log_arity)
            cur_gen = gl.exp_power_of_2(cur_gen, log_arity)
        # Final polynomial evaluation.
        x_fin = gl.mul(cur_shift, pow(cur_gen, cur_index, gl.P))
        expect = ext_horner(final_poly, (x_fin, 0))
        if expect != cur_val:
            raise VerificationError("final FRI polynomial mismatch")

    return ch.finalize()


def _aux_ext_pair(c0: int, c1: int) -> tuple:
    return (c0 % gl.P, c1 % gl.P)
