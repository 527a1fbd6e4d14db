"""Lifted STARK prover orchestration (the eager pipeline of
``miden_tpu.stark.prover``; reference crates/lifted-stark/src/prover/mod.rs).

1.  Order AIRs by ascending trace height (stable on instance index) and bind
    the statement + shape into Fiat-Shamir.
2.  Commit main traces: per-trace coset LDE (blowup B, canonical per-height
    shifts) into one lifted LMCS tree.
3.  Sample aux randomness, build aux (LogUp) traces, commit aux, send aux
    values.
4.  Sample α (constraint fold) and β (AIR accumulation); per AIR evaluate
    the α-folded constraints on its native quotient coset (a strided view of
    its committed LDE), divide by Z_H, upsample to D_max, Horner-accumulate
    with β under cyclic lifting.
5.  Commit the quotient: interpolate, split into D contiguous degree-<N
    chunks, LDE all chunks in one batched NTT, commit.
6.  Sample the OOD point z ∉ H ∪ sK; open [preprocessed?, main, aux,
    quotient] at [z, z·ω_H] through the PCS (DEEP + FRI + queries).

A statement whose AIRs declare preprocessed columns takes the
:class:`~.preprocessed.Preprocessed` bundle of
:func:`~.preprocessed.build_preprocessed`: its root is observed before the
statement, and its LDEs are read by the constraints and opened first.

Everything from the traces to the query indices runs on the traces' device
under a device challenger; the transcript is read back once, then the query
openings once more.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..dist.context import active_mesh
from ..dist.lmcs_dist import build_tree_sharded
from ..dist.mesh import gather_rows
from ..dist.ntt_dist import coset_lde_sharded
from ..field import gl
from ..field import goldilocks as F
from ..merkle import lmcs
from ..ntt import ntt
from ..transcript.challenger import DuplexChallenger, TranscriptData
from ..transcript.device_challenger import DeviceChallenger, DeviceProverChannel
from ..utils.tracing import span
from . import interp, pcs
from .air import Air, Expr, Folder, MultiAir, VectorBackend
from .domains import LiftedDomain, log_quotient_degree
from .params import PcsParams
from .preprocessed import validate_preprocessed


@dataclass
class Statement:
    """Verifier-visible statement: the AIRs + shared public inputs."""

    multi_air: MultiAir
    publics: list
    aux_inputs: list = field(default_factory=list)

    def observe(self, challenger, log_heights) -> None:
        """FS binding of statement + shape (prover/mod.rs:284-292)."""
        self.multi_air.observe(challenger, self.publics, self.aux_inputs)
        challenger.observe(len(self.multi_air.airs))
        for lh in log_heights:
            challenger.observe(lh)


@dataclass
class Proof:
    log_heights: list  # instance order
    data: TranscriptData

    def size_in_bytes(self) -> int:
        return self.data.size_in_bytes() + len(self.log_heights)


@dataclass
class StarkOutput:
    digest: list
    proof: Proof


def proof_order(log_heights: list) -> list:
    """Instance indices sorted by (log_height, instance index) ascending."""
    return sorted(range(len(log_heights)), key=lambda i: (log_heights[i], i))


def _as_device(m, device) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        return m.to(device)
    return F.to_torch(m, device)


def commit_traces(matrices: list, log_blowup: int, hash=lmcs.POSEIDON2_HASH) -> lmcs.LmcsTree:
    """LDE each trace (int64 tensor (n, w)) on its canonical coset and commit
    them into one tree.

    Under an active :func:`~..dist.context.use_mesh`, on the conditions of
    ``miden_tpu/stark/prover.py:112-140``, the max-height LDE runs row-sharded
    (cross stages exchanged between ranks) and a Poseidon2 tree as per-rank
    subtrees under gathered top layers."""
    mesh = active_mesh()
    d = mesh.size if mesh is not None else 1
    max_n = max(m.shape[0] for m in matrices)
    ldes = []
    for m in matrices:
        n, w = m.shape
        if w == 0:
            ldes.append(torch.zeros((n << log_blowup, 0), dtype=torch.int64, device=m.device))
            continue
        shift = gl.canonical_lde_shift((n.bit_length() - 1) + log_blowup)
        if mesh is not None and n == max_n and n % d == 0 and n // d >= 2:
            ldes.append(coset_lde_sharded(m, log_blowup, shift, mesh))
        else:
            ldes.append(ntt.coset_lde(m, log_blowup, shift))
    if mesh is not None and (max_n << log_blowup) % d == 0 and hash.name == "poseidon2":
        return build_tree_sharded(ldes, mesh)
    return lmcs.build_tree([gather_rows(lde, mesh) for lde in ldes], hash=hash)


def _periodic_on_domain(pattern, n, log_d, shift, device) -> torch.Tensor:
    """Periodic column values over the quotient domain (size n·2^log_d): the
    period-p pattern's interpolant evaluated at x^{n/p}, tiled."""
    p = len(pattern)
    s_eff = gl.exp_power_of_2(shift, (n // p).bit_length() - 1)
    evals = F.to_torch(np.asarray(pattern, dtype=np.uint64)[:, None], device)
    small = ntt.coset_lde(evals, log_d, s_eff)  # (p·D, 1)
    return small[:, 0].repeat(n // p)


#: quotient domains of at least this many points go through the recorded
#: constraint program whatever the AIR (miden_tpu/stark/prover.py:176-197)
PROGRAM_MIN_POINTS = 1 << 21


def uses_program(air: Air, n: int, log_d: int) -> bool:
    """Whether an AIR of n rows and quotient degree 2^log_d is evaluated by
    its recorded constraint program (:mod:`.interp`, Q1 on the card) rather
    than the eager evaluator: the AIRs that declare ``prefer_interp`` (the
    three VM AIRs) and every domain of PROGRAM_MIN_POINTS or more, as in
    ``miden_tpu``. The choice depends on the AIR and its size only, never on
    the device."""
    return getattr(air, "prefer_interp", False) or (n << log_d) >= PROGRAM_MIN_POINTS


def evaluate_quotient(
    air: Air,
    domain: LiftedDomain,
    main_lde,
    aux_lde,
    log_d: int,
    alpha,
    publics,
    randomness,
    aux_values,
    pp_lde=None,
):
    """α-folded constraints / Z_H over the native quotient coset, (n·D, 2):
    through the AIR's recorded program where :func:`uses_program` says so,
    else through the eager evaluator. ``pp_lde`` is the AIR's committed
    preprocessed LDE, when it declares preprocessed columns."""
    args = (air, domain, main_lde, aux_lde, log_d, alpha, publics, randomness, aux_values, pp_lde)
    if uses_program(air, domain.trace_height, log_d):
        return evaluate_quotient_program(*args)
    return evaluate_quotient_eager(*args)


def _coset_tables(air: Air, domain: LiftedDomain, log_d: int, device) -> tuple:
    """The quotient coset's selectors (is-first, is-last, is-transition),
    periodic columns and 1/Z_H, each (n·D,). Z_H(x_i) = shift^n·ω_D^{i mod
    D} − 1 takes D distinct values."""
    n = domain.trace_height
    d = 1 << log_d
    nd = n * d
    shift = domain.lde_shift
    pts = pcs.coset_points(nd.bit_length() - 1, shift, device)
    z_vals = []
    v = gl.exp_power_of_2(shift, domain.log_trace_height)
    wd = gl.two_adic_generator(log_d) if log_d else 1
    for _ in range(d):
        z_vals.append(gl.sub(v, 1))
        v = gl.mul(v, wd)
    z_tile = F.to_torch(np.asarray(z_vals, dtype=np.uint64), device).repeat(n)
    last_den_raw = F.sub(pts, F.const(gl.inv(domain.trace_generator), device=device))
    sels = (
        F.mul(z_tile, F.inv(F.sub(pts, F.const(1, device=device)))),
        F.mul(z_tile, F.inv(last_den_raw)),
        last_den_raw,
    )
    periodic = [_periodic_on_domain(p, n, log_d, shift, device) for p in air.periodic_columns]
    inv_z = [gl.inv(zv) for zv in z_vals]
    inv_tile = F.to_torch(np.asarray(inv_z, dtype=np.uint64), device).repeat(n)
    return sels, periodic, inv_tile


def quotient_program_inputs(
    air: Air, domain: LiftedDomain, main_lde, aux_lde, log_d: int, alpha, publics, randomness,
    aux_values, pp_lde=None,
) -> tuple:
    """``(prog, inputs, 1/Z_H)`` of :func:`evaluate_quotient_program`: the
    AIR's program and its run over the quotient coset, read straight out of
    the LDEs (a row-strided view; current and next rows, with no transposed
    or rolled copy), and the (n·D,) inverse vanishing values."""
    nd = domain.trace_height << log_d
    stride = domain.lde_height // nd
    sels, periodic, inv_tile = _coset_tables(air, domain, log_d, main_lde.device)
    prog, inp = interp.program_inputs(
        air, main_lde[::stride], aux_lde[::stride] if air.aux_width else None, sels, publics,
        randomness, aux_values, periodic, alpha,
        pp=pp_lde[::stride] if pp_lde is not None else None, next_offset=1 << log_d,
    )
    return prog, inp, inv_tile


def evaluate_quotient_program(
    air: Air, domain: LiftedDomain, main_lde, aux_lde, log_d: int, alpha, publics, randomness,
    aux_values, pp_lde=None,
):
    """:func:`evaluate_quotient` through the AIR's recorded constraint
    program (``miden_tpu``'s ``_evaluate_quotient_interp``): Q1 on the card,
    the plain twin on the CPU."""
    prog, inp, inv_tile = quotient_program_inputs(
        air, domain, main_lde, aux_lde, log_d, alpha, publics, randomness, aux_values, pp_lde
    )
    return F.ext_mul_base(interp.run_program(prog, inp), inv_tile)


#: log2 of the quotient-domain points the eager evaluator takes at once.
#: Each block repeats every constraint's launches, so the block is as
#: large as fits: a stacked family of G constraints holds G × 2 int64 a
#: point. The eager evaluator takes only the AIRs of :func:`uses_program`'s
#: "no", whose domains are below 2^21 points: at most two blocks.
QUOTIENT_BLOCK_LOG = 20


def evaluate_quotient_eager(
    air: Air, domain: LiftedDomain, main_lde, aux_lde, log_d: int, alpha, publics, randomness,
    aux_values, pp_lde=None,
):
    """:func:`evaluate_quotient` with torch ops (the ``_evaluate_quotient_dev``
    formulation of ``miden_tpu``): every constraint is evaluated over blocks
    of 2^``QUOTIENT_BLOCK_LOG`` coset points at once."""
    device = main_lde.device
    d = 1 << log_d
    nd = domain.trace_height * d
    stride = domain.lde_height // nd

    # columns as contiguous rows: (w, nd), and the next-row view rolled by D
    main_t = main_lde[::stride].T.contiguous()
    main_next = torch.roll(main_t, -d, dims=1)
    if aux_lde is not None:
        aux_t = aux_lde[::stride].T.contiguous()
        aux_next = torch.roll(aux_t, -d, dims=1)
    if pp_lde is not None:
        pp_t = pp_lde[::stride].T.contiguous()
        pp_next = torch.roll(pp_t, -d, dims=1)
    sels, periodic, inv_tile = _coset_tables(air, domain, log_d, device)

    out = torch.empty((nd, 2), dtype=torch.int64, device=device)
    block = min(nd, 1 << QUOTIENT_BLOCK_LOG)
    for start in range(0, nd, block):
        rows = slice(start, start + block)
        backend = VectorBackend((block,), device)

        def main_fn(col, offset=0, rows=rows, backend=backend):
            return Expr(backend, "base", (main_next if offset else main_t)[col, rows])

        def aux_fn(col, offset=0, rows=rows, backend=backend):
            src = aux_next if offset else aux_t
            return Expr(backend, "ext", F.ext(src[2 * col, rows], src[2 * col + 1, rows]))

        def preprocessed_fn(col, offset=0, rows=rows, backend=backend):
            return Expr(backend, "base", (pp_next if offset else pp_t)[col, rows])

        folder = Folder(
            backend,
            main_fn=main_fn,
            aux_fn=aux_fn,
            preprocessed_fn=preprocessed_fn if pp_lde is not None else None,
            periodic=[Expr(backend, "base", col[rows]) for col in periodic],
            publics=[Expr(backend, "base", publics[i]) for i in range(publics.shape[0])],
            randomness=[Expr(backend, "ext", randomness[i]) for i in range(randomness.shape[0])],
            aux_values=[Expr(backend, "ext", aux_values[i]) for i in range(aux_values.shape[0])],
            selectors=tuple(Expr(backend, "base", sel[rows]) for sel in sels),
            alpha=Expr(backend, "ext", alpha),
        )
        air.eval(folder)
        acc = folder.acc
        assert acc is not None, "AIR produced no constraints"
        val = acc.val if acc.kind == "ext" else F.ext_from_base(acc.val)
        out[rows] = F.ext_mul_base(val.expand(block, 2), inv_tile[rows])
    return out


def upsample_evals(evals, shift: int, added_bits: int):
    """LDE ext evals (natural, shift s) from size L to L·2^added_bits on the
    same shift (reference quotient.rs:45 upsample)."""
    coeffs = ntt.coset_interpolate_bitrev(evals, shift)
    return ntt.evaluate_coeffs_on_coset(coeffs, added_bits, shift)


def _accumulate_step(reps: int, acc, q, beta):
    """acc ← lift(acc)·β + q (Horner across AIRs under cyclic lifting)."""
    return F.ext_add(F.ext_mul(acc.repeat(reps, 1), beta), q)


def _quotient_chunks_dev(acc, domain: LiftedDomain, log_d: int, log_blowup: int):
    """Split Q (evals over (s_K, N·D)) into D contiguous degree-<N chunks and
    LDE them on (s_K, N·B) as one (N·B, 2D) matrix. Chunk t is the stride-D
    slice of the bit-reversed coefficients starting at bitrev_D(t)."""
    n = domain.trace_height
    d = 1 << log_d
    coeffs_br = ntt.coset_interpolate_bitrev(acc, domain.lde_shift).reshape(n, d, 2)
    br = [int(format(t, f"0{log_d}b")[::-1], 2) if log_d else 0 for t in range(d)]
    chunk_coeffs = coeffs_br[:, br].reshape(n, 2 * d)  # columns t0.c0, t0.c1, t1.c0, ...
    return ntt.evaluate_coeffs_on_coset(chunk_coeffs, log_blowup, domain.lde_shift)


def commit_quotient(acc, domain: LiftedDomain, log_d: int, log_blowup: int, hash=lmcs.POSEIDON2_HASH):
    """Commit the D quotient chunks' LDEs as one 2D-column matrix; under an
    active mesh a Poseidon2 tree is built row-sharded
    (``miden_tpu/stark/prover.py:440-455``)."""
    chunks = _quotient_chunks_dev(acc, domain, log_d, log_blowup)
    mesh = active_mesh()
    if mesh is not None and chunks.shape[0] % mesh.size == 0 and hash.name == "poseidon2":
        return build_tree_sharded([chunks], mesh)
    return lmcs.build_tree([chunks], hash=hash)


def _ext_stack(scalars: list, device):
    if not scalars:
        return torch.zeros((0, 2), dtype=torch.int64, device=device)
    return torch.stack(scalars)


def _ood_valid_flag(domain: LiftedDomain, z):
    """Device boolean: z ∉ {0} ∪ H ∪ sK (reference domain.rs:539-560),
    asserted at the final readback instead of rejection-looping."""
    one = F.ext_const((1, 0), device=z.device)

    def is_one(v):
        return (v == one).all()

    in_h = is_one(F.ext_exp_power_of_2(z, domain.log_trace_height))
    zs = F.ext_mul_base(z, F.const(gl.inv(domain.lde_shift), device=z.device))
    in_k = is_one(F.ext_exp_power_of_2(zs, domain.log_lde_height))
    return (z != 0).any() & ~in_h & ~in_k


def prove(
    params: PcsParams,
    statement: Statement,
    traces: list,
    challenger: DuplexChallenger,
    preprocessed=None,
    device="cuda",
) -> StarkOutput:
    """Prove a multi-AIR statement on ``device``. ``traces[i]``: numpy u64
    or int64 tensor (n_i, width_i), instance order. The challenger must be
    pre-bound to the protocol parameters.

    ``preprocessed``: the :class:`~.preprocessed.Preprocessed` bundle,
    required exactly when some AIR declares preprocessed columns. Its
    commitment is observed into Fiat-Shamir before the statement
    (prover/mod.rs:282-285) but never enters the transcript: the verifier
    holds it as trusted setup input."""
    airs = statement.multi_air.airs
    if (preprocessed is not None) != any(a.preprocessed_width > 0 for a in airs):
        raise ValueError(
            "preprocessed bundle must be supplied exactly when some AIR "
            "declares preprocessed columns"
        )
    assert len(airs) == len(traces)
    traces = [_as_device(t, device) for t in traces]
    log_blowup = params.log_blowup
    hash_cfg = params.lmcs_hash()
    log_heights = [t.shape[0].bit_length() - 1 for t in traces]
    for t, a in zip(traces, airs):
        assert tuple(t.shape) == (1 << (t.shape[0].bit_length() - 1), a.width)

    order = proof_order(log_heights)
    max_domain = LiftedDomain.canonical(max(log_heights), log_blowup)
    domains = [max_domain.sub_domain(log_heights[i]) for i in order]

    if preprocessed is not None:
        validate_preprocessed(statement, traces, preprocessed, params)

    dch = DeviceChallenger.from_host(challenger, device)
    if preprocessed is not None:
        dch.observe_arr(preprocessed.tree.root_dev())
    statement.observe(dch, log_heights)
    channel = DeviceProverChannel(dch)

    log_ds = [log_quotient_degree(airs[i].constraint_degree()) for i in order]
    log_d = max(log_ds)
    assert log_d <= log_blowup, "constraint degree exceeds blowup"

    # 1. Commit main traces (proof order).
    with span("commit to main traces"):
        main_tree = commit_traces([traces[i] for i in order], log_blowup, hash=hash_cfg)
    channel.send_commitment(main_tree.root_dev())

    # 2. Randomness → aux traces (instance order) → external assertions →
    #    commit (proof order) → send aux values.
    max_rand = max((a.num_randomness for a in airs), default=0)
    randomness = [channel.sample_ext() for _ in range(max_rand)]
    with span("build aux traces"):
        # device tensors: aux (n, 2·aux_width) and aux values (num_aux_values, 2)
        aux_pairs = []
        for a, t in zip(airs, traces):
            with span("aux trace of one AIR", air=type(a).__name__):
                aux_pairs.append(
                    a.build_aux_trace(t, statement.publics, statement.aux_inputs, randomness[: a.num_randomness])
                )
    with span("commit to aux traces"):
        aux_tree = commit_traces([aux_pairs[i][0] for i in order], log_blowup, hash=hash_cfg)
    channel.send_commitment(aux_tree.root_dev())
    aux_values = [aux_pairs[i][1] for i in order]
    for vals in aux_values:
        channel.send_ext_slice(vals)

    # 3. Constraint fold / accumulation challenges.
    alpha = channel.sample_ext()
    beta = channel.sample_ext()
    pub_d = F.to_torch(np.asarray([int(p) % gl.P for p in statement.publics], dtype=np.uint64), device)
    rand_d = _ext_stack(randomness, device)

    # 4. Per-AIR quotient evaluation + Horner accumulation under lifting.
    pp_for_air = preprocessed.trace_index_for_air() if preprocessed else {}
    acc = None
    for k, i in enumerate(order):
        with span("evaluate constraints", instance=k, air=type(airs[i]).__name__):
            air = airs[i]
            dom = domains[k]
            q = evaluate_quotient(
                air,
                dom,
                main_tree.matrices[k],
                aux_tree.matrices[k] if air.aux_width else None,
                log_ds[k],
                alpha,
                pub_d,
                rand_d[: air.num_randomness],
                aux_values[k],
                preprocessed.tree.matrices[pp_for_air[i]] if air.preprocessed_width else None,
            )
            if log_ds[k] < log_d:
                q = upsample_evals(q, dom.lde_shift, log_d - log_ds[k])
            if acc is None:
                acc = q
            else:
                acc = _accumulate_step((dom.trace_height << log_d) // acc.shape[0], acc, q, beta)

    # 5. Commit quotient.
    with span("commit to quotient poly chunks"):
        quotient_tree = commit_quotient(acc, max_domain, log_d, log_blowup, hash=hash_cfg)
    channel.send_commitment(quotient_tree.root_dev())

    # 6. OOD point + PCS opening at [z, z·ω_H].
    z = channel.sample_ext()
    channel.check("ood point outside domains", _ood_valid_flag(max_domain, z))
    z_next = F.ext_mul_base(z, F.const(max_domain.trace_generator, device=device))
    # opened tree order: [preprocessed?, main, aux, quotient] (prover/mod.rs:552-554)
    input_trees = ([preprocessed.tree] if preprocessed else []) + [main_tree, aux_tree, quotient_tree]
    with span("open"):
        fri_trees, idx_arr = pcs.open_with_channel(params, max_domain, input_trees, [z, z_next], channel)

    # THE blocking readback: transcript + query indices in one transfer.
    with span("transcript readback"):
        idx_host = channel.materialize(extra=idx_arr)
    mask = (1 << max_domain.log_lde_height) - 1
    idx_raw = [int(v) & mask for v in idx_host]
    return _query_phase_and_finalize(
        params, max_domain, input_trees, fri_trees, idx_raw, channel, log_heights, idx_arr
    )


def _query_phase_and_finalize(
    params, max_domain, input_trees, fri_trees, idx_raw, channel, log_heights, idx_arr
) -> StarkOutput:
    """Open every committed tree at the query indices: one device gather per
    tree, one readback, then host-side hint assembly."""
    with span("query phase"):
        mask = (1 << max_domain.log_lde_height) - 1
        idx_dev = idx_arr & mask
        flats, metas, raws = [], [], []
        for tree in input_trees:
            flat, meta = lmcs.gather_query_data(tree, idx_dev)
            flats.append(flat)
            metas.append(meta)
            raws.append(idx_raw)
        size = max_domain.lde_height
        cur_idx, cur_raw = idx_dev, idx_raw
        for tree in fri_trees:
            size >>= params.log_folding_arity
            cur_idx = cur_idx & (size - 1)
            cur_raw = [d & (size - 1) for d in cur_raw]
            flat, meta = lmcs.gather_query_data(tree, cur_idx)
            flats.append(flat)
            metas.append(meta)
            raws.append(cur_raw)
        host_vals = F.to_numpy(torch.cat(flats))  # second (final) readback
        off = 0
        for flat, meta, raw in zip(flats, metas, raws):
            n = flat.shape[0]
            lmcs.emit_opening_hints(channel, host_vals[off : off + n], meta, raw)
            off += n

    digest, data = channel.finalize()
    return StarkOutput(digest=digest, proof=Proof(log_heights=log_heights, data=data))
