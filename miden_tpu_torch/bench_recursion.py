"""In-VM STARK verifier workloads: the programs of ``chip_smoke.py``'s phase 11.

The in-VM verifier's MASM (``stdlib`` ``stark/*``, ``pcs::fri::frie2f4``,
``sys::vm::constraints_eval``) holds procedures, not programs. This module
holds the programs that drive them on a real proof, built from a
:class:`~miden_tpu_torch.stdlib.recursion.RecursionFixture`. Shared by
``chip_smoke.py`` and ``tests/test_torch_recursion.py``; each builder gives
the source text that ``miden_tpu``'s tests build for the same fixture.

- :func:`fri_query_program`: one query's FRI fold chain (native FRIE2F4 per
  layer) and the final-polynomial identity, with every layer record staged
  directly (``tests/test_recursion_masm.py``
  ``test_fri_query_program_proves_e2e``).
- :func:`transcript_replay_program` with :func:`replay_advice`: the full
  in-VM Fiat–Shamir replay of a proof — statement binding, every challenge
  derived by the in-VM coin, then per sampled query f_red(x), the DEEP
  quotient, the FRI fold chain and the final-polynomial identity
  (``test_deep_fri_full_transcript_replay``). It leaves
  [1, z, α_deep, β_deep] on top of the stack, and ends at stack depth 16
  so that it can be proved (the test's program ends at depth 23).
- :func:`ood_identity_program`: every AIR's OOD constraint fold checked by
  its registry-authenticated ACE circuit, the folds combined into the
  quotient identity against the committed quotient claims
  (``tests/test_sysvm_masm.py`` ``test_ood_identity_in_vm``). It leaves 1.
- :data:`LOAD_CIRCUIT_PROGRAM` with :func:`load_circuit_advice`: one
  circuit blob authenticated against the registry root, and refused when
  a bit of it is flipped.
- :func:`vm_recursion_fixture`: a VM proof's statement, rebuilt from its
  public claim, and its fixture.

``python -m miden_tpu_torch.bench_recursion [--device cpu]`` proves the
replay program of the ``repeat.40`` fib proof at ``TEST_PARAMS`` on the card
(or the CPU) and prints one JSON line: seconds, cycles, log heights, proof
size and digest, peak host memory. Two such lines with equal digests hold
the card's proof equal to the CPU's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import time

from .field import gl
from .merkle import lmcs
from .stark.air import Expr, Folder, ScalarBackend
from .stark.domains import LiftedDomain, log_quotient_degree
from .stark.prover import proof_order
from .stark.verifier import ext_horner, pattern_coeffs
from .stdlib.recursion import extract_recursion_fixture
from .transcript.challenger import DuplexChallenger
from .vm.ace_registry import circuit_blob, registry_path, vm_registry

# fri_query_program's scratch: layer records, FRI rows, final polynomial,
# Horner challenge word
FRI_LAYERS, FRI_ROWS, FRI_FINAL, FRI_SCRATCH = 6000, 7000, 8000, 9000

# transcript_replay_program's memory map (SPTR word-aligned for HORNEREXT)
PUB, LH, SCR, SPTR = 100000, 100100, 100200, 100296
Z, FZ, BETAD, ALPHAD, XS = 100300, 100310, 100320, 100324, 100340
IDX = 100400
OOD, LAY, ROWS, OPEN, FINAL = 110000, 120000, 121000, 122000, 130000

# ood_identity_program's memory map
OOD_CLAIMS, PUBS, RANDS, AUXV, ALPH = 200000, 210000, 210100, 210200, 210300
CPTR, CSCR = 220000, 210400
VPTRS = (300000, 400000, 500000)


def vm_recursion_fixture(proof, params):
    """(statement, fixture) of a :class:`~miden_tpu_torch.vm.prove.VmProof`:
    the statement rebuilt from the proof's public claim as
    ``verify_program`` does, the transcript replayed from the protocol seed."""
    from .vm.prove import protocol_seed, vm_statement

    st = vm_statement(
        proof.program_hash, proof.stack_inputs, proof.stack_outputs,
        proof.kernel_digests, proof.deferred_root,
    )
    fx = extract_recursion_fixture(
        params, st, proof.stark, DuplexChallenger(protocol_seed())
    )
    return st, fx


def fri_query_program(fx, index: int | None = None) -> str:
    """One query's fold chain and final-polynomial identity; the query is
    ``index`` (one of ``fx.indices``, the first by default). Leaves 1 at
    stack depth 16 (the test's program ends at depth 17, which the prover
    refuses)."""
    d = fx.indices[0] if index is None else index
    lptr, rptr, fptr, sptr = FRI_LAYERS, FRI_ROWS, FRI_FINAL, FRI_SCRATCH
    n_layers = len(fx.fri_betas)
    stores = []
    log_rows = fx.log_lde_height - 2
    for r, beta in enumerate(fx.fri_betas):
        stores += [
            f"push.{beta[0]} push.{lptr + 8 * r} mem_store",
            f"push.{beta[1]} push.{lptr + 8 * r + 1} mem_store",
            f"push.{log_rows} push.{lptr + 8 * r + 2} mem_store",
        ]
        log_rows -= 2
    stores += [
        f"push.{c} push.{fptr + i} mem_store"
        for i, c in enumerate(fx.final_poly_flat)
    ]
    stores += [
        f"push.{c} push.{rptr + 8 * r + i} mem_store"
        for r, row in enumerate(fx.fri_rows[d])
        for i, c in enumerate(row)
    ]
    x_d = gl.mul(
        fx.lde_shift, pow(gl.two_adic_generator(fx.log_lde_height), d, gl.P)
    )
    v = fx.deep_q[d]
    return f"""
    use miden::core::pcs::fri::frie2f4
    begin
        {' '.join(stores)}
        push.{rptr} push.{lptr} push.{n_layers}
        push.{v[1]} push.{v[0]} push.{x_d} push.{d}
        exec.frie2f4::verify_query
        drop
        push.{sptr} push.{len(fx.final_poly_flat) // 2} push.{fptr}
        movdn.5 movdn.5 movdn.5
        exec.frie2f4::verify_final_poly
        push.1 swap drop
    end
    """


def replay_advice(fx) -> list:
    """The advice stack of :func:`transcript_replay_program`: the proof's
    transcript in channel order, then per sampled query (in sampling order,
    repeats included) its opened rows and FRI rows."""
    adv = []
    adv += fx.publics
    adv += fx.log_heights
    adv += list(fx.main_root)
    adv += list(fx.aux_root)
    adv += fx.aux_values_flat
    adv += list(fx.quotient_root)
    adv += fx.claims_flat
    adv.append(fx.deep_pow_witness)
    for root, w in zip(fx.fri_roots, fx.fri_pow_witnesses):
        adv += list(root)
        adv.append(w)
    adv += fx.final_poly_flat
    adv.append(fx.query_pow_witness)
    for d in fx.raw_index_samples:
        adv += fx.opened_rows[d]
        for row in fx.fri_rows[d]:
            adv += row
    return adv


def _check_replay_map(fx, params) -> None:
    """The replay program's memory regions, [start, end) each, in address
    order, must not overlap (the map is fixed; the proof sets the sizes)."""
    n_row_felts = len(fx.opened_rows[fx.indices[0]])
    n_layers = len(fx.fri_betas)
    regions = [
        ("PUB", PUB, len(fx.publics)),
        ("LH", LH, len(fx.log_heights)),
        ("SCR", SCR, 8 + len(fx.aux_values_flat)),
        ("SPTR", SPTR, 4),
        ("Z", Z, 2), ("FZ", FZ, 4), ("BETAD", BETAD, 2), ("ALPHAD", ALPHAD, 4),
        ("XS", XS, 1),
        ("IDX", IDX, params.num_queries),
        ("OOD", OOD, len(fx.claims_flat)),
        ("LAY", LAY, 8 * n_layers),
        ("ROWS", ROWS, 8 * n_layers),
        ("OPEN", OPEN, n_row_felts),
        ("FINAL", FINAL, len(fx.final_poly_flat)),
    ]
    for (a, start, n), (b, nxt, _) in zip(regions, regions[1:]):
        if start + n > nxt:
            raise ValueError(
                f"replay memory map: {a} [{start}, {start + n}) runs into {b} at {nxt}"
            )


def transcript_replay_program(fx, params, seed) -> str:
    """The full in-VM transcript replay of the proof ``fx`` was extracted
    from, made under ``params`` with a challenger seeded by ``seed``; reads
    :func:`replay_advice`. Leaves [1, z0, z1, α0, α1, β0, β1]."""
    _check_replay_map(fx, params)
    n_airs = len(fx.log_heights)
    log_lde = fx.log_lde_height
    log_h = log_lde - params.log_blowup
    n_claims = len(fx.claims_flat)
    n_ext_per_point = n_claims // 4  # two points, 2 felts per ext
    n_row_felts = len(fx.opened_rows[fx.indices[0]])
    n_layers = len(fx.fri_betas)
    n_final = len(fx.final_poly_flat)
    nq = params.num_queries
    h_gen = gl.two_adic_generator(log_h)
    return f"""
    use miden::core::stark::random_coin
    use miden::core::stark::public_inputs
    use miden::core::stark::ood_frames
    use miden::core::stark::deep_queries
    use miden::core::pcs::fri::frie2f4
    begin
        push.{seed[3]}.{seed[2]}.{seed[1]}.{seed[0]}
        exec.random_coin::init
        # ---- statement binding ----
        push.{len(fx.publics)} push.{PUB} exec.ood_frames::load_hints
        push.{n_airs} push.{LH} exec.ood_frames::load_hints
        push.{len(fx.publics)} push.{PUB} exec.public_inputs::observe_publics
        push.{LH} push.{n_airs} exec.public_inputs::observe_shape
        # ---- commits + challenges ----
        push.4 push.{SCR} exec.ood_frames::load_evals
        repeat.{fx.n_randomness} exec.random_coin::sample_ext drop drop end
        push.4 push.{SCR} exec.ood_frames::load_evals
        push.{len(fx.aux_values_flat)} push.{SCR + 8} exec.ood_frames::load_evals
        exec.random_coin::sample_ext drop drop
        exec.random_coin::sample_ext drop drop
        push.4 push.{SCR} exec.ood_frames::load_evals
        # ---- OOD point ----
        push.{log_lde} push.{log_h} exec.deep_queries::sample_ood_point
        push.{Z} mem_store push.{Z + 1} mem_store
        # ---- claims + DEEP challenges ----
        push.{n_claims} push.{OOD} exec.ood_frames::load_evals
        adv_push.1 push.{params.deep_pow_bits} swap
        exec.random_coin::check_witness
        exec.random_coin::sample_ext
        push.{ALPHAD} mem_store push.{ALPHAD + 1} mem_store
        exec.random_coin::sample_ext
        push.{BETAD} mem_store push.{BETAD + 1} mem_store
        # ---- f_red(z), f_red(z·h) ----
        push.{ALPHAD} push.{n_ext_per_point} push.{OOD}
        exec.ood_frames::horner_ext_mem
        push.{FZ} mem_store push.{FZ + 1} mem_store
        push.{ALPHAD} push.{n_ext_per_point} push.{OOD + n_claims // 2}
        exec.ood_frames::horner_ext_mem
        push.{FZ + 2} mem_store push.{FZ + 3} mem_store
        # ---- FRI commit replay ----
        push.{params.folding_pow_bits} push.{log_lde}
        push.{LAY} push.{n_layers}
        exec.frie2f4::preload_layers
        push.{n_final} push.{FINAL} exec.ood_frames::load_evals
        adv_push.1 push.{params.query_pow_bits} swap
        exec.random_coin::check_witness
        # ---- query index sampling ----
        push.{nq} push.{IDX}
        swap dup neq.0
        while.true
            swap
            push.{log_lde} exec.random_coin::sample_bits
            dup.1 mem_store
            add.1 swap sub.1
            dup neq.0
        end
        drop drop
        # ---- per-query DEEP + FRI ----
        push.{nq} push.{IDX}
        swap dup neq.0
        while.true
            swap
            # => [qptr, n]
            push.{n_row_felts} push.{OPEN} exec.ood_frames::load_hints
            push.{8 * n_layers} push.{ROWS} exec.ood_frames::load_hints
            # f_red(x)
            push.{ALPHAD} push.{n_row_felts} push.{OPEN}
            exec.ood_frames::horner_base_mem
            # => [fx0, fx1, qptr, n]
            push.{log_lde} dup.3 mem_load
            exec.deep_queries::compute_x
            # => [x, fx0, fx1, qptr, n]
            dup push.{XS} mem_store
            # deep_quotient input [x, h, Z(2), FZ0(2), FZ1(2), FX(2), B(2)]
            push.{BETAD + 1} mem_load push.{BETAD} mem_load
            # => [b0, b1, x, fx0, fx1, qptr, n]
            movup.3 movup.4 swap
            # => [fx0, fx1, b0, b1, x, qptr, n]
            push.{FZ + 3} mem_load push.{FZ + 2} mem_load
            push.{FZ + 1} mem_load push.{FZ} mem_load
            push.{Z + 1} mem_load push.{Z} mem_load
            push.{h_gen}
            # => [h, z0, z1, fz00, fz01, fz10, fz11, fx0, fx1, b0, b1, x, qptr, n]
            movup.11
            # => [x, h, Z, FZ0, FZ1, FX, B, qptr, n]
            exec.deep_queries::deep_quotient
            # => [q0, q1, qptr, n]
            push.{ROWS} push.{LAY} push.{n_layers}
            movdn.4 movdn.4 movdn.4
            # => [q0, q1, nl, LAY, ROWS, qptr, n]
            push.{XS} mem_load
            dup.6 mem_load
            # => [idx, poe, q0, q1, nl, LAY, ROWS, qptr, n]
            exec.frie2f4::verify_query
            # => [idx_fin, x_fin, V(2), qptr, n]
            drop
            push.{SPTR} push.{n_final // 2} push.{FINAL}
            movdn.5 movdn.5 movdn.5
            # => [x_fin, V(2), FINAL, n_ext, SPTR, qptr, n]
            exec.frie2f4::verify_final_poly
            # => [qptr, n]
            add.1 swap sub.1
            dup neq.0
        end
        drop drop
        # surface the derived DEEP challenges for the host cross-check
        push.{BETAD + 1} mem_load push.{BETAD} mem_load
        push.{ALPHAD + 1} mem_load push.{ALPHAD} mem_load
        push.{Z + 1} mem_load push.{Z} mem_load
        push.1
        # drop seven of the sixteen zeros under the results: a proved
        # program ends at stack depth 16
        repeat.7 movup.7 drop end
    end
    """


def _expected_folds(statement, fx, params, order, claim_quad, aux_value_off):
    """Each AIR's α-folded constraint value at z, as the scalar verifier
    computes it, with its periodic values and selector arguments."""
    airs = statement.multi_air.airs
    max_domain = LiftedDomain.canonical(max(fx.log_heights), params.log_blowup)
    expected, periodic_vals, sels_args = {}, {}, {}
    for k, i in enumerate(order):
        air = airs[i]
        dom = max_domain.sub_domain(fx.log_heights[i])
        be = ScalarBackend()
        PHI = (0, 1)
        zl = dom.lift(fx.z)
        periodic = []
        for pat in air.periodic_columns:
            coeffs = pattern_coeffs(list(pat))
            arg = gl.ext_exp_power_of_2(
                zl, dom.log_trace_height - (len(pat).bit_length() - 1)
            )
            periodic.append(ext_horner(list(reversed(coeffs)), arg))
        periodic_vals[i] = periodic
        sels = dom.selectors_at(fx.z)
        sels_args[i] = (dom.log_trace_height, dom.log_lift_ratio)
        f = Folder(
            be,
            main_fn=lambda c, o=0, _k=k: Expr(
                be, "ext", claim_quad(o, 0, _k, c)
            ),
            aux_fn=lambda c, o=0, _k=k: Expr(
                be, "ext",
                gl.ext_add(
                    claim_quad(o, 1, _k, 2 * c),
                    gl.ext_mul(PHI, claim_quad(o, 1, _k, 2 * c + 1)),
                ),
            ),
            preprocessed_fn=None,
            periodic=[Expr(be, "ext", v) for v in periodic],
            publics=[Expr(be, "base", v) for v in fx.publics],
            randomness=[
                Expr(be, "ext", r)
                for r in fx.randomness[: air.num_randomness]
            ],
            aux_values=[
                Expr(be, "ext", tuple(
                    fx.aux_values_flat[2 * (aux_value_off[i] + j) + t]
                    for t in range(2)
                ))
                for j in range(air.num_aux_values)
            ],
            selectors=tuple(
                Expr(be, "ext", v)
                for v in (sels.is_first_row, sels.is_last_row,
                          sels.is_transition)
            ),
            alpha=Expr(be, "ext", fx.alpha),
        )
        air.eval(f)
        v = f.acc.val
        expected[i] = v if f.acc.kind != "base" else (v, 0)
    return expected, periodic_vals, sels_args


def ood_identity_program(statement, fx, params) -> tuple[str, list]:
    """(source, advice) of the in-VM OOD identity of a VM proof: per AIR in
    proof order, its circuit loaded from advice and authenticated, its var
    section built from the staged claims, EVALCIRCUIT on the host's fold,
    q_i = fold / Z_H_i(z') folded by β; then Q(z) from the quotient claims
    asserted equal. Leaves 1."""
    airs = statement.multi_air.airs
    order = proof_order(fx.log_heights)
    max_log_h = max(fx.log_heights)
    log_d = max(
        log_quotient_degree(airs[i].constraint_degree()) for i in order
    )
    d_chunks = 1 << log_d
    _root, _leaves, circuits = vm_registry()

    # ---- claims layout offsets (quads) ----
    aw_main = [lmcs.aligned_width(airs[i].width) for i in order]
    aw_aux = [lmcs.aligned_width(2 * airs[i].aux_width) for i in order]
    aw_q = lmcs.aligned_width(2 * d_chunks)
    per_point = sum(aw_main) + sum(aw_aux) + aw_q

    def claims_off(p, tree, k):
        base = p * per_point
        if tree >= 1:
            base += sum(aw_main)
        if tree >= 2:
            base += sum(aw_aux)
        base += sum((aw_main if tree == 0 else aw_aux)[:k]) if tree < 2 else 0
        return OOD_CLAIMS + 2 * base

    claims = fx.claims_flat
    n_pub = len(fx.publics)

    def claim_quad(p, tree, k, col):
        base = claims_off(p, tree, k) - OOD_CLAIMS
        return (claims[base + 2 * col], claims[base + 2 * col + 1])

    aux_value_off = {}
    off = 0
    for i in order:
        aux_value_off[i] = off
        off += airs[i].num_aux_values

    expected, periodic_vals, sels_args = _expected_folds(
        statement, fx, params, order, claim_quad, aux_value_off
    )

    # ---- advice stream + program source ----
    adv = []
    adv += fx.publics
    rands_flat = [c for r in fx.randomness for c in r]
    adv += rands_flat
    adv += fx.aux_values_flat
    adv += list(fx.alpha)
    src_parts = [f"""
        push.{len(fx.publics)} push.{PUBS} exec.ood_frames::load_hints
        push.{len(rands_flat)} push.{RANDS} exec.ood_frames::load_hints
        push.{len(fx.aux_values_flat)} push.{AUXV} exec.ood_frames::load_hints
        push.2 push.{ALPH} exec.ood_frames::load_hints
        push.{len(claims)} push.{OOD_CLAIMS} exec.ood_frames::load_hints
        push.0 push.0
    """]
    adv += claims

    for k, i in enumerate(order):
        air = airs[i]
        circ = circuits[i]
        w, aw = air.width, air.aux_width
        vptr = VPTRS[k]
        blob = circuit_blob(circ)
        adv.append(len(blob))
        adv += blob
        for sib in registry_path(i):
            adv += list(reversed(sib))
        n_consts = len(circ.const_values)
        blob_ptr = CPTR + 2
        log_h_i, lift_i = sels_args[i]
        # var-section offsets (felts)
        o_main = 0
        o_mainn = o_main + 2 * w
        o_aux = o_mainn + 2 * w
        o_auxn = o_aux + 4 * aw
        o_sel = o_auxn + 4 * aw
        o_per = o_sel + 6
        o_pub = o_per + 2 * len(air.periodic_columns)
        o_rand = o_pub + 2 * n_pub
        o_auxv = o_rand + 4 * air.num_randomness
        o_alph = o_auxv + 4 * air.num_aux_values
        o_const = o_alph + 4
        o_x = o_const + 2 * n_consts
        o_exp = o_x + 2
        if (o_exp + 2) // 2 != circ.n_inputs + n_consts + 2:
            raise ValueError(f"AIR {i}: the var section does not match its circuit's inputs")
        per_stores = " ".join(
            f"push.{v[0]} push.{vptr + o_per + 2 * j} mem_store "
            f"push.{v[1]} push.{vptr + o_per + 2 * j + 1} mem_store"
            for j, v in enumerate(periodic_vals[i])
        )
        src_parts.append(f"""
        # ==== AIR {i} ({type(air).__name__}) ====
        push.{CSCR} push.2 push.{i} push.{CPTR}
        exec.constraints_eval::load_circuit
        drop
        push.{2 * w} push.{claims_off(0, 0, k)} push.{vptr + o_main}
        exec.constraints_eval::copy_felts
        push.{2 * w} push.{claims_off(1, 0, k)} push.{vptr + o_mainn}
        exec.constraints_eval::copy_felts
        push.{4 * aw} push.{claims_off(0, 1, k)} push.{vptr + o_aux}
        exec.constraints_eval::copy_felts
        push.{4 * aw} push.{claims_off(1, 1, k)} push.{vptr + o_auxn}
        exec.constraints_eval::copy_felts
        push.{lift_i} push.{log_h_i} push.{fx.z[1]} push.{fx.z[0]}
        exec.constraints_eval::selectors_at
        push.{vptr + o_sel} mem_store push.{vptr + o_sel + 1} mem_store
        push.{vptr + o_sel + 2} mem_store push.{vptr + o_sel + 3} mem_store
        push.{vptr + o_sel + 4} mem_store push.{vptr + o_sel + 5} mem_store
        {per_stores}
        push.{n_pub} push.{PUBS} push.{vptr + o_pub}
        exec.constraints_eval::expand_base
        push.{2 * air.num_randomness} push.{RANDS} push.{vptr + o_rand}
        exec.constraints_eval::expand_base
        push.{2 * air.num_aux_values} push.{AUXV + 2 * aux_value_off[i]}
        push.{vptr + o_auxv}
        exec.constraints_eval::expand_base
        push.2 push.{ALPH} push.{vptr + o_alph}
        exec.constraints_eval::expand_base
        push.{n_consts} push.{blob_ptr + 4} push.{vptr + o_const}
        exec.constraints_eval::expand_base
        push.0 push.{vptr + o_x} mem_store
        push.1 push.{vptr + o_x + 1} mem_store
        push.{expected[i][0]} push.{vptr + o_exp} mem_store
        push.{expected[i][1]} push.{vptr + o_exp + 1} mem_store
        push.{circ.num_eval} push.{blob_ptr + 4 + n_consts}
        push.{vptr + 2 * circ.num_vars}
        exec.constraints_eval::copy_felts
        push.{circ.num_eval} push.{circ.num_vars} push.{vptr}
        exec.constraints_eval::eval
        # q_i = expected / Z_H_i(z'); acc = acc*beta + q_i
        push.{expected[i][1]} push.{expected[i][0]}
        push.{fx.z[1]} push.{fx.z[0]}
        push.{lift_i} exec.deep_queries::ext_exp_pow2
        push.{log_h_i} exec.deep_queries::ext_exp_pow2
        push.0 push.1 ext2sub
        ext2div
        # => [q0, q1, acc0, acc1]: acc' = acc*beta + q
        movup.2 movup.3 swap
        push.{fx.beta[1]} push.{fx.beta[0]}
        ext2mul
        ext2add
        """)

    qoff = claims_off(0, 2, 0)
    src_parts.append(f"""
        # ==== OOD quotient identity ====
        push.{d_chunks} push.{qoff}
        push.{fx.z[1]} push.{fx.z[0]}
        push.{max_log_h} exec.deep_queries::ext_exp_pow2
        exec.constraints_eval::quotient_at_z
        # => [Q0, Q1, acc0, acc1]
        movup.2 assert_eq
        assert_eq
        push.1
    """)

    src = (
        "use miden::core::sys::vm::constraints_eval\n"
        "use miden::core::stark::ood_frames\n"
        "use miden::core::stark::deep_queries\n"
        "begin\n" + "\n".join(src_parts) + "\nend\n"
    )
    return src, adv


#: load_circuit on AIR 2's circuit (the smallest, Poseidon2PermutationAir):
#: leaves its blob pointer, 100002
LOAD_CIRCUIT_PROGRAM = """
    use miden::core::sys::vm::constraints_eval
    begin
        push.6000 push.2 push.2 push.100000
        exec.constraints_eval::load_circuit
    end
    """


def load_circuit_advice(tamper: bool = False) -> list:
    """:data:`LOAD_CIRCUIT_PROGRAM`'s advice: AIR 2's blob length, the blob
    (bit 0 of its eighth felt flipped when ``tamper``), its registry path."""
    blob = circuit_blob(vm_registry()[2][2])
    if tamper:
        blob[7] ^= 1
    adv = [len(blob)] + list(blob)
    for sib in registry_path(2):
        adv += list(reversed(sib))
    return adv


#: the VM fib whose TEST_PARAMS proof ``tests/test_sysvm_masm.py`` verifies in the VM
FIB_40 = "begin push.0 push.1 repeat.40 swap dup.1 add end swap drop swap drop end"


def main(argv=None) -> int:
    """Proves FIB_40 at TEST_PARAMS, then the transcript replay of that proof,
    on ``--device``; prints one JSON line about the replay's proof."""
    import torch

    from .stark import TEST_PARAMS
    from .stdlib import assemble_with_stdlib, stdlib_event_handlers
    from .vm import assemble
    from .vm.processor import AdviceProvider
    from .vm.prove import protocol_seed, prove_program, verify_program

    ap = argparse.ArgumentParser(prog="python -m miden_tpu_torch.bench_recursion")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = ap.parse_args(argv).device
    if dev == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_recursion: no CUDA device")
        from .utils import cuda

        cuda.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip() if dev == "cuda" else None
    handlers = stdlib_event_handlers()
    _, fib = prove_program(assemble(FIB_40), params=TEST_PARAMS, device=dev)
    _, fx = vm_recursion_fixture(fib, TEST_PARAMS)
    prog = assemble_with_stdlib(transcript_replay_program(fx, TEST_PARAMS, protocol_seed()))
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, proof = prove_program(prog, advice=AdviceProvider(stack=replay_advice(fx)), params=TEST_PARAMS,
                               event_handlers=handlers, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    verify_program(proof, params=TEST_PARAMS, partial=True)
    data = proof.to_bytes()
    print(json.dumps({
        "device": dev, "card": card, "host_cpus": os.cpu_count(), "torch_threads": torch.get_num_threads(),
        "cycles": out.clk, "log_heights": list(proof.stark.log_heights), "prove_s": prove_s,
        "proof_bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
        "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
