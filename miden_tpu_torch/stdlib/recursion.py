"""Host-side fixture builder for the in-VM recursive verifier tower.

Role analog of the reference's recursive-verifier advice generator
(crates/test-utils/src/recursive_verifier.rs
``generate_advice_inputs``): given a real proof produced by this
framework's prover, extract every transcript segment and query opening in
the exact order the stark/{ood_frames,deep_queries} and pcs/fri MASM
modules consume them, plus the derived challenges for cross-checks.

The extraction replays the verifier's channel walk
(stark/verifier.py:62-382) — same reads, same sampling points — so the
in-VM random coin fed these advice values reproduces the host challenger
felt-for-felt.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..field import gl
from ..merkle import lmcs
from ..stark.domains import LiftedDomain, log_quotient_degree
from ..stark.prover import proof_order
from ..transcript.challenger import VerifierChannel


@dataclass
class RecursionFixture:
    """Everything the in-VM verifier tower needs, in consumption order."""

    log_heights: list
    publics: list
    # transcript stream pieces (advice), in channel order
    main_root: tuple
    n_randomness: int
    aux_root: tuple
    aux_values_flat: list  # base felts, proof order
    quotient_root: tuple
    claims_flat: list  # base felts: per z, per tree, per matrix, aligned ext
    deep_pow_witness: int
    fri_roots: list  # list of 4-felt tuples
    fri_pow_witnesses: list
    final_poly_flat: list  # 2 * final_degree base felts (descending ext)
    query_pow_witness: int
    # derived challenges (for cross-checks / masm cross-validation)
    randomness: list
    alpha: tuple
    beta: tuple
    z: tuple
    z_resamples: int  # sample_ext calls rejected by sample_ood_point
    alpha_deep: tuple
    beta_deep: tuple
    fri_betas: list
    indices: list  # sorted unique query indices
    raw_index_samples: list  # the num_queries sampled felts (pre-dedup)
    # per unique query index: the aligned opened rows, flattened in the
    # f_red(x) Horner order (tree -> matrix -> aligned cols)
    opened_rows: dict  # index -> list[int]
    # per unique query index: per FRI round, the 4 ext row values in the
    # op's bit-reversed stack order [q0, q2, q1, q3] (8 felts)
    fri_rows: dict  # index -> list[list[int]]
    # expected values for test assertions
    f_red_z: list  # per point, ext
    f_red_x: dict  # index -> ext
    deep_q: dict  # index -> ext
    # domain metadata
    log_lde_height: int
    lde_shift: int
    trace_generator: int


def extract_recursion_fixture(params, statement, proof, challenger):
    """Walk the proof transcript exactly as verify() does, recording the
    advice streams; ``challenger`` must be a fresh DuplexChallenger seeded
    the same way the proof was produced."""
    airs = statement.multi_air.airs
    hash_cfg = params.lmcs_hash()
    log_heights = list(proof.log_heights)
    order = proof_order(log_heights)
    max_log_h = max(log_heights)
    max_domain = LiftedDomain.canonical(max_log_h, params.log_blowup)
    domains = [max_domain.sub_domain(log_heights[i]) for i in order]
    big_n = max_domain.lde_height

    log_ds = [log_quotient_degree(airs[i].constraint_degree()) for i in order]
    log_d = max(log_ds)
    d_chunks = 1 << log_d

    statement.observe(challenger, log_heights)
    ch = VerifierChannel(proof.data, challenger)

    main_root = ch.read_commitment()
    max_rand = max((a.num_randomness for a in airs), default=0)
    randomness = [ch.sample_ext() for _ in range(max_rand)]
    aux_root = ch.read_commitment()
    aux_values_flat = []
    for i in order:
        for v in ch.read_ext_slice(airs[i].num_aux_values):
            aux_values_flat.extend(v)
    alpha = ch.sample_ext()
    beta = ch.sample_ext()
    quotient_root = ch.read_commitment()

    # OOD point with resample count (the masm rejection loop must replay
    # the exact number of rejected samples)
    z_resamples = 0
    while True:
        z = ch.sample_ext()
        if z == (0, 0) or max_domain.contains_base(
            z, shifted=False
        ) or max_domain.contains_base(z, shifted=True):
            z_resamples += 1
            continue
        break
    z_next = gl.ext_mul_base(z, max_domain.trace_generator)
    zs = [z, z_next]

    main_widths = [airs[i].width for i in order]
    aux_widths = [2 * airs[i].aux_width for i in order]
    quotient_widths = [2 * d_chunks]
    main_heights = [domains[k].lde_height for k in range(len(order))]
    tree_widths = [main_widths, aux_widths, quotient_widths]
    tree_heights = [main_heights, main_heights, [big_n]]
    tree_roots = [main_root, aux_root, quotient_root]

    claims = []
    claims_flat = []
    for _ in zs:
        per_tree = []
        for widths in tree_widths:
            per_matrix = []
            for w in widths:
                vals = ch.read_ext_slice(lmcs.aligned_width(w))
                for v in vals:
                    claims_flat.extend(v)
                per_matrix.append(vals)
            per_tree.append(per_matrix)
        claims.append(per_tree)

    deep_pow_witness = ch._next_fields(1)[0]
    if not ch.challenger.check_witness(params.deep_pow_bits, deep_pow_witness):
        raise ValueError("deep PoW replay failed")
    alpha_deep = ch.sample_ext()
    beta_deep = ch.sample_ext()

    log_arity = params.log_folding_arity
    arity = params.arity
    final_domain_size = params.final_poly_degree << params.log_blowup
    fri_roots, fri_pow, fri_betas = [], [], []
    size = big_n
    while size > final_domain_size:
        fri_roots.append(ch.read_commitment())
        w = ch._next_fields(1)[0]
        if not ch.challenger.check_witness(params.folding_pow_bits, w):
            raise ValueError("folding PoW replay failed")
        fri_pow.append(w)
        fri_betas.append(ch.sample_ext())
        size >>= log_arity
    final_poly = ch.read_ext_slice(params.final_poly_degree)
    final_poly_flat = [c for v in final_poly for c in v]

    query_pow_witness = ch._next_fields(1)[0]
    if not ch.challenger.check_witness(params.query_pow_bits, query_pow_witness):
        raise ValueError("query PoW replay failed")
    raw_samples = [
        ch.sample_bits(max_domain.log_lde_height)
        for _ in range(params.num_queries)
    ]
    indices = sorted(set(raw_samples))

    # openings (hint stream)
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
    for root in fri_roots:
        size >>= log_arity
        idx = sorted({d % size for d in indices})
        fri_opened.append(
            lmcs.verify_batch(root, [2 * arity], size, idx, ch, hash=hash_cfg)
        )

    # f_red(z_j)
    f_red_z = []
    for per_tree in claims:
        acc = (0, 0)
        for per_matrix in per_tree:
            for vals in per_matrix:
                for v in vals:
                    acc = gl.ext_add(gl.ext_mul(acc, alpha_deep), v)
        f_red_z.append(acc)

    s_max = max_domain.lde_shift
    w_max = gl.two_adic_generator(max_domain.log_lde_height)
    opened_rows, f_red_x, deep_q, fri_rows = {}, {}, {}, {}
    for d in indices:
        flat = []
        for (rows, heights), widths in zip(opened, tree_widths):
            max_h = max(heights)
            for row, w in zip(rows[d % max_h], widths):
                vals = [int(v) for v in row]
                vals += [0] * (lmcs.aligned_width(w) - len(vals))
                flat.extend(vals)
        opened_rows[d] = flat
        acc = (0, 0)
        for v in flat:
            acc = gl.ext_add(gl.ext_mul(acc, alpha_deep), (v % gl.P, 0))
        f_red_x[d] = acc
        x_d = gl.mul(s_max, pow(w_max, d, gl.P))
        q_val, bpow = (0, 0), (1, 0)
        for j, zj in enumerate(zs):
            num = gl.ext_sub(f_red_z[j], f_red_x[d])
            den = gl.ext_sub(zj, (x_d, 0))
            q_val = gl.ext_add(q_val, gl.ext_mul(bpow, gl.ext_mul(num, gl.ext_inv(den))))
            bpow = gl.ext_mul(bpow, beta_deep)
        deep_q[d] = q_val

        # per-round FRI rows in the FRIE2F4 stack order [q0, q2, q1, q3]
        per_round = []
        cur_index, cur_size = d, big_n
        for r in range(len(fri_roots)):
            rows_count = cur_size >> log_arity
            k_row = cur_index % rows_count
            row = [int(v) for v in fri_opened[r][k_row][0]]
            y = [(row[2 * j], row[2 * j + 1]) for j in range(arity)]
            per_round.append(
                [c for j in (0, 2, 1, 3) for c in y[j]]
            )
            cur_index, cur_size = k_row, rows_count
        fri_rows[d] = per_round

    ch.finalize()

    return RecursionFixture(
        log_heights=log_heights,
        publics=[int(p) % gl.P for p in statement.publics],
        main_root=main_root,
        n_randomness=max_rand,
        aux_root=aux_root,
        aux_values_flat=aux_values_flat,
        quotient_root=quotient_root,
        claims_flat=claims_flat,
        deep_pow_witness=deep_pow_witness,
        fri_roots=fri_roots,
        fri_pow_witnesses=fri_pow,
        final_poly_flat=final_poly_flat,
        query_pow_witness=query_pow_witness,
        randomness=randomness,
        alpha=alpha,
        beta=beta,
        z=z,
        z_resamples=z_resamples,
        alpha_deep=alpha_deep,
        beta_deep=beta_deep,
        fri_betas=fri_betas,
        indices=indices,
        raw_index_samples=raw_samples,
        opened_rows=opened_rows,
        fri_rows=fri_rows,
        f_red_z=f_red_z,
        f_red_x=f_red_x,
        deep_q=deep_q,
        log_lde_height=max_domain.log_lde_height,
        lde_shift=s_max,
        trace_generator=max_domain.trace_generator,
    )
