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

Steps 2–6 up to the query indices are the four ``STAGES`` (main, aux,
quotient, open), each a function of a :class:`ProofLayout` (what the shape
fixes), a channel and an environment of tensors. :mod:`.fused` runs each as
one phase, and a final phase for the transcript payload. :func:`prove`
hands the proof to :func:`~.fused.prove_fused` where
:func:`~.fused.use_fused` says (on the card unless ``fused=False``, also
under an NCCL mesh; on the CPU only with ``fused=True``; never on the card
under a gloo mesh): it keeps the phases of the proof's shape, captured into
CUDA graphs on the card at the shape's second proof and replayed from then
on. Elsewhere it runs the phases once, eagerly (:func:`~.fused.prove_eager`).
Both give the same bytes.

Under an active :func:`~..dist.context.use_mesh` where :func:`shards_rows`
holds, every stage keeps the max-height rows sharded (``dist/prover.py``
lists what and how); the bytes are one device's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..dist.context import active_mesh
from ..dist.lmcs_dist import build_tree_sharded
from ..dist.mesh import RowShard, block_rows, gather_rows, next_rows
from ..dist.ntt_dist import coset_interpolate_bitrev_sharded, coset_lde_sharded, evaluate_coeffs_on_coset_sharded
from ..field import gl
from ..field import goldilocks as F
from ..merkle import lmcs
from ..ntt import ntt
from ..transcript.challenger import DuplexChallenger, TranscriptData
from ..transcript.device_challenger import DeviceChallenger
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


def shards_rows(mesh, max_n: int, hash) -> bool:
    """Whether a proof over ``mesh`` keeps its max-height rows sharded from
    the first commit to the openings (``miden_tpu/stark/prover.py:112-140``,
    ``miden_tpu/dist/lmcs_dist.py``): under a Poseidon2 tree, when the
    ``D`` ranks split the max trace height ``max_n`` into blocks of at
    least two rows (what the sharded NTT takes). Then every max-height LDE,
    everything derived from one over the max LDE domain (the quotient and
    its chunks, the DEEP evaluations, the first FRI layers) and the bottom
    layers of their trees are :class:`~..dist.mesh.RowShard` s. A trace of
    fewer than ``2·D`` rows is proved whole on every rank. Under the other
    hashes the sharded LDEs are gathered into a whole tree, as in
    ``miden_tpu``, and the proof goes on whole."""
    return (
        mesh is not None and hash.name == "poseidon2" and max_n % mesh.size == 0 and max_n // mesh.size >= 2
    )


def commit_traces(matrices: list, log_blowup: int, hash=lmcs.POSEIDON2_HASH) -> lmcs.LmcsTree:
    """LDE each trace (int64 tensor (n, w)) on its canonical coset and commit
    them into one tree.

    Under an active :func:`~..dist.context.use_mesh`, on the conditions of
    ``miden_tpu/stark/prover.py:112-140``, the max-height LDE runs row-sharded
    (cross stages exchanged between ranks); where :func:`shards_rows` holds,
    the tree is :func:`~..dist.lmcs_dist.build_tree_sharded`'s (its
    max-height matrices and bottom layers this rank's blocks), else the LDEs
    are gathered into a whole tree."""
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
    if shards_rows(mesh, max_n, hash):
        return build_tree_sharded(ldes, mesh)
    return lmcs.build_tree([gather_rows(lde, mesh) for lde in ldes], hash=hash)


def _periodic_on_domain(pattern, n, log_d, shift, device, start: int = 0, count: int | None = None) -> torch.Tensor:
    """Periodic column values over the quotient domain (size n·2^log_d): the
    period-p pattern's interpolant evaluated at x^{n/p}, tiled; points
    ``[start, start + count)`` of it (all by default)."""
    p = len(pattern)
    s_eff = gl.exp_power_of_2(shift, (n // p).bit_length() - 1)
    evals = F.table(pattern, device)[:, None]
    small = ntt.coset_lde(evals, log_d, s_eff)[:, 0]  # (p·D,)
    period = p << log_d
    count = (n << log_d) if count is None else count
    if start % period == 0 and count % period == 0:
        return small.repeat(count // period)
    return small.index_select(0, torch.remainder(torch.arange(start, start + count, device=device), period))


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
    mesh=None,
):
    """α-folded constraints / Z_H over the native quotient coset, (n·D, 2):
    through the AIR's recorded program where :func:`uses_program` says so,
    else through the eager evaluator. ``pp_lde`` is the AIR's committed
    preprocessed LDE, when it declares preprocessed columns.

    Where ``main_lde`` is a :class:`~..dist.mesh.RowShard` of ``mesh``,
    each rank evaluates the points of its block and returns them as a
    RowShard: the current rows are its block of the LDEs, the next rows of
    its last ``D`` points come from the next rank (:func:`_quotient_rows`)."""
    args = (air, domain, main_lde, aux_lde, log_d, alpha, publics, randomness, aux_values, pp_lde, mesh)
    if uses_program(air, domain.trace_height, log_d):
        return evaluate_quotient_program(*args)
    return evaluate_quotient_eager(*args)


def _quotient_points(domain: LiftedDomain, log_d: int, mesh) -> tuple:
    """``(start, count)``: the quotient-domain points this rank evaluates:
    all of them, or over a mesh its block of ``n·D/ranks``."""
    nd = domain.trace_height << log_d
    if mesh is None:
        return 0, nd
    return mesh.rank * (nd // mesh.size), nd // mesh.size


def _coset_tables(air: Air, domain: LiftedDomain, log_d: int, device, mesh=None) -> tuple:
    """The quotient coset's selectors (is-first, is-last, is-transition),
    periodic columns and 1/Z_H, each (count,) over this rank's points
    (:func:`_quotient_points`; never the whole domain's table over a mesh).
    Z_H(x_i) = shift^n·ω_D^{i mod D} − 1 takes D distinct values; a block
    starts at a multiple of D."""
    n = domain.trace_height
    d = 1 << log_d
    nd = n * d
    start, count = _quotient_points(domain, log_d, mesh)
    shift = domain.lde_shift
    pts = pcs.coset_points(nd.bit_length() - 1, shift, device, start, count)
    z_vals = []
    v = gl.exp_power_of_2(shift, domain.log_trace_height)
    wd = gl.two_adic_generator(log_d) if log_d else 1
    for _ in range(d):
        z_vals.append(gl.sub(v, 1))
        v = gl.mul(v, wd)
    z_tile = F.table(z_vals, device).repeat(count // d)
    last_den_raw = F.sub(pts, F.const(gl.inv(domain.trace_generator), device=device))
    sels = (
        F.mul(z_tile, F.inv(F.sub(pts, F.const(1, device=device)))),
        F.mul(z_tile, F.inv(last_den_raw)),
        last_den_raw,
    )
    periodic = [_periodic_on_domain(p, n, log_d, shift, device, start, count) for p in air.periodic_columns]
    inv_z = [gl.inv(zv) for zv in z_vals]
    inv_tile = F.table(inv_z, device).repeat(count // d)
    return sels, periodic, inv_tile


def _quotient_rows(domain: LiftedDomain, log_d: int, ldes, mesh) -> tuple:
    """The quotient coset's rows of each LDE in ``ldes`` (None stays None):
    ``(current, halo)``. Alone, ``current`` is the row-strided view of the
    whole LDE and ``halo`` is None (point r's next row is point
    ``(r + D) mod nd``). Over a mesh, ``current`` is the strided view of
    this rank's block and ``halo`` the next ``D`` points, from the next
    rank's block (``D·stride`` LDE rows, :func:`~..dist.mesh.next_rows`):
    the next rows of the block's last ``D`` points."""
    nd = domain.trace_height << log_d
    stride = domain.lde_height // nd
    if mesh is None:
        return tuple(None if m is None else m[::stride] for m in ldes), None
    rows, halo = domain.lde_height, (1 << log_d) * stride
    cur = tuple(None if m is None else block_rows(m, rows, mesh)[::stride] for m in ldes)
    nxt = tuple(None if m is None else next_rows(m, rows, halo, mesh)[::stride] for m in ldes)
    return cur, nxt


def _lde_device(m):
    return (m.local if isinstance(m, RowShard) else m).device


def quotient_program_inputs(
    air: Air, domain: LiftedDomain, main_lde, aux_lde, log_d: int, alpha, publics, randomness,
    aux_values, pp_lde=None, mesh=None,
) -> tuple:
    """``(prog, inputs, 1/Z_H)`` of :func:`evaluate_quotient_program`: the
    AIR's program and its run over the quotient coset (over a mesh, this
    rank's points), read straight out of the LDEs (a row-strided view;
    current and next rows, with no transposed or rolled copy), and the
    inverse vanishing values."""
    # in the order of the program's sources: main, preprocessed, aux
    cur, halo = _quotient_rows(domain, log_d, (main_lde, pp_lde, aux_lde if air.aux_width else None), mesh)
    sels, periodic, inv_tile = _coset_tables(air, domain, log_d, _lde_device(main_lde), mesh)
    prog, inp = interp.program_inputs(
        air, cur[0], cur[2], sels, publics, randomness, aux_values, periodic, alpha, pp=cur[1],
        next_offset=1 << log_d, halo=halo,
    )
    return prog, inp, inv_tile


def _as_rows(q, domain: LiftedDomain, log_d: int, mesh):
    """A quotient's values as the prover holds them: whole, or over a mesh
    this rank's block as a RowShard."""
    return q if mesh is None else RowShard(q, domain.trace_height << log_d)


def evaluate_quotient_program(
    air: Air, domain: LiftedDomain, main_lde, aux_lde, log_d: int, alpha, publics, randomness,
    aux_values, pp_lde=None, mesh=None,
):
    """:func:`evaluate_quotient` through the AIR's recorded constraint
    program (``miden_tpu``'s ``_evaluate_quotient_interp``): Q1 on the card,
    the plain twin on the CPU."""
    mesh = mesh if isinstance(main_lde, RowShard) else None
    prog, inp, inv_tile = quotient_program_inputs(
        air, domain, main_lde, aux_lde, log_d, alpha, publics, randomness, aux_values, pp_lde, mesh
    )
    return _as_rows(F.ext_mul_base(interp.run_program(prog, inp), inv_tile), domain, log_d, mesh)


#: log2 of the quotient-domain points the eager evaluator takes at once.
#: Each block repeats every constraint's launches, so the block is as
#: large as fits: a stacked family of G constraints holds G × 2 int64 a
#: point. The eager evaluator takes only the AIRs of :func:`uses_program`'s
#: "no", whose domains are below 2^21 points: at most two blocks.
QUOTIENT_BLOCK_LOG = 20


def evaluate_quotient_eager(
    air: Air, domain: LiftedDomain, main_lde, aux_lde, log_d: int, alpha, publics, randomness,
    aux_values, pp_lde=None, mesh=None,
):
    """:func:`evaluate_quotient` with torch ops (the ``_evaluate_quotient_dev``
    formulation of ``miden_tpu``): every constraint is evaluated over blocks
    of 2^``QUOTIENT_BLOCK_LOG`` coset points at once."""
    mesh = mesh if isinstance(main_lde, RowShard) else None
    device = _lde_device(main_lde)
    d = 1 << log_d
    cur, halo = _quotient_rows(domain, log_d, (main_lde, pp_lde, aux_lde), mesh)

    def columns(i):
        """(w, nd) columns as contiguous rows, and the next-row view: rolled
        by D, or shifted by D with the halo at the end."""
        t = cur[i].T.contiguous()
        if halo is None:
            return t, torch.roll(t, -d, dims=1)
        return t, torch.cat([t[:, d:], halo[i].T], dim=1)

    main_t, main_next = columns(0)
    if pp_lde is not None:
        pp_t, pp_next = columns(1)
    if aux_lde is not None:
        aux_t, aux_next = columns(2)
    nd = main_t.shape[1]
    sels, periodic, inv_tile = _coset_tables(air, domain, log_d, device, mesh)

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
    return _as_rows(out, domain, log_d, mesh)


def upsample_evals(evals, shift: int, added_bits: int, mesh=None):
    """LDE ext evals (natural, shift s) from size L to L·2^added_bits on the
    same shift (reference quotient.rs:45 upsample); a RowShard of ``mesh``
    through the sharded NTT's two halves."""
    if isinstance(evals, RowShard):
        coeffs = coset_interpolate_bitrev_sharded(evals, shift, mesh)
        return evaluate_coeffs_on_coset_sharded(coeffs, added_bits, shift, mesh)
    coeffs = ntt.coset_interpolate_bitrev(evals, shift)
    return ntt.evaluate_coeffs_on_coset(coeffs, added_bits, shift)


def _accumulate_step(reps: int, acc, q, beta, mesh=None):
    """acc ← lift(acc)·β + q (Horner across AIRs under cyclic lifting). A
    RowShard ``q`` takes this rank's rows of the lifted acc, ``(k·S + j) mod
    h`` (acc is whole while it is shorter)."""
    if isinstance(q, RowShard):
        lifted = block_rows(acc, q.rows, mesh)
        return RowShard(F.ext_add(F.ext_mul(lifted, beta), q.local), q.rows)
    return F.ext_add(F.ext_mul(acc.repeat(reps, 1), beta), q)


def _quotient_chunks_dev(acc, domain: LiftedDomain, log_d: int, log_blowup: int, mesh=None):
    """Split Q (evals over (s_K, N·D)) into D contiguous degree-<N chunks and
    LDE them on (s_K, N·B) as one (N·B, 2D) matrix. Chunk t is the stride-D
    slice of the bit-reversed coefficients starting at bitrev_D(t).

    A RowShard ``acc`` of ``mesh`` stays sharded: the sharded interpolation,
    the regrouping of each D consecutive coefficients into one row (local to
    a block: a block of ``N·D/ranks`` coefficients holds whole rows, since
    the ranks divide N where :func:`shards_rows` holds), the sharded
    evaluation."""
    n = domain.trace_height
    d = 1 << log_d
    br = ntt.bitrev_index(d, _lde_device(acc))
    if isinstance(acc, RowShard):
        coeffs = coset_interpolate_bitrev_sharded(acc, domain.lde_shift, mesh).local
        chunk_coeffs = RowShard(coeffs.reshape(-1, d, 2).index_select(1, br).reshape(-1, 2 * d), n)
        return evaluate_coeffs_on_coset_sharded(chunk_coeffs, log_blowup, domain.lde_shift, mesh)
    coeffs_br = ntt.coset_interpolate_bitrev(acc, domain.lde_shift).reshape(n, d, 2)
    chunk_coeffs = coeffs_br.index_select(1, br).reshape(n, 2 * d)  # columns t0.c0, t0.c1, t1.c0, ...
    return ntt.evaluate_coeffs_on_coset(chunk_coeffs, log_blowup, domain.lde_shift)


def commit_quotient(acc, domain: LiftedDomain, log_d: int, log_blowup: int, hash=lmcs.POSEIDON2_HASH, mesh=None):
    """Commit the D quotient chunks' LDEs as one 2D-column matrix; a
    RowShard ``acc`` of ``mesh`` is committed as a sharded tree
    (``miden_tpu/stark/prover.py:440-455``)."""
    chunks = _quotient_chunks_dev(acc, domain, log_d, log_blowup, mesh)
    if isinstance(chunks, RowShard):
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


@dataclass
class ProofLayout:
    """What the stages of a proof know besides their tensors, all fixed by
    the statement's shape: the AIRs, their log heights, the proof order
    (ascending height), the lifted max domain, each AIR's domain and log
    quotient degree (proof order), the largest of those degrees, and the
    preprocessed trace of each AIR that declares one."""

    params: PcsParams
    airs: list
    log_heights: list
    order: list
    max_domain: LiftedDomain
    domains: list
    log_ds: list
    log_d: int
    pp_for_air: dict

    @classmethod
    def of(cls, params: PcsParams, statement: Statement, traces: list, preprocessed=None) -> "ProofLayout":
        """Check the traces and the preprocessed bundle against the statement
        (``traces[i]``: any array of shape (n_i, width_i), instance order)."""
        airs = statement.multi_air.airs
        if (preprocessed is not None) != any(a.preprocessed_width > 0 for a in airs):
            raise ValueError(
                "preprocessed bundle must be supplied exactly when some AIR "
                "declares preprocessed columns"
            )
        assert len(airs) == len(traces)
        log_heights = [t.shape[0].bit_length() - 1 for t in traces]
        for t, a in zip(traces, airs):
            assert tuple(t.shape) == (1 << (t.shape[0].bit_length() - 1), a.width)
        if preprocessed is not None:
            validate_preprocessed(statement, traces, preprocessed, params)
        order = proof_order(log_heights)
        max_domain = LiftedDomain.canonical(max(log_heights), params.log_blowup)
        log_ds = [log_quotient_degree(airs[i].constraint_degree()) for i in order]
        log_d = max(log_ds)
        assert log_d <= params.log_blowup, "constraint degree exceeds blowup"
        return cls(
            params=params, airs=list(airs), log_heights=log_heights, order=order,
            max_domain=max_domain, domains=[max_domain.sub_domain(log_heights[i]) for i in order],
            log_ds=log_ds, log_d=log_d,
            pp_for_air=preprocessed.trace_index_for_air() if preprocessed else {},
        )


def bind_statement(statement: Statement, challenger: DuplexChallenger, preprocessed, log_heights, device):
    """The device challenger bound to the preprocessed root (when there is
    one), the statement and the shape (prover/mod.rs:282-292)."""
    dch = DeviceChallenger.from_host(challenger, device)
    if preprocessed is not None:
        dch.observe_arr(preprocessed.tree.root_dev())
    statement.observe(dch, log_heights)
    return dch


def statement_tensors(statement: Statement, device) -> tuple:
    """The statement's publics and aux inputs as (n,) tensors on ``device``."""
    return tuple(
        F.to_torch(np.asarray([int(v) % gl.P for v in vals], dtype=np.uint64), device)
        for vals in (statement.publics, statement.aux_inputs)
    )


# ---------------------------------------------------------------------------
# The stages of a proof. Each ``stage(lay, channel, env)`` reads its inputs
# from ``env`` and writes its outputs there: the inputs "traces" (instance
# order, on the device), "publics", "aux_inputs" and "pp_tree" (None
# without preprocessed columns), then "main_tree"; "aux_tree",
# "aux_values" (proof order), "randomness", "alpha", "beta";
# "quotient_tree", "z"; "fri_trees", "idx". :mod:`.fused` runs them, one
# phase each.
# ---------------------------------------------------------------------------


def stage_main(lay: ProofLayout, channel, env: dict) -> None:
    """Commit the main traces (proof order)."""
    traces = env["traces"]
    with span("commit to main traces"):
        tree = commit_traces([traces[i] for i in lay.order], lay.params.log_blowup, hash=lay.params.lmcs_hash())
    channel.send_commitment(tree.root_dev())
    env["main_tree"] = tree


def stage_aux(lay: ProofLayout, channel, env: dict) -> None:
    """Randomness → aux traces (instance order) → commit (proof order) →
    aux values → the constraint fold and accumulation challenges α, β."""
    max_rand = max((a.num_randomness for a in lay.airs), default=0)
    randomness = [channel.sample_ext() for _ in range(max_rand)]
    with span("build aux traces"):
        # device tensors: aux (n, 2·aux_width) and aux values (num_aux_values, 2)
        aux_pairs = []
        for a, t in zip(lay.airs, env["traces"]):
            with span("aux trace of one AIR", air=type(a).__name__):
                aux_pairs.append(
                    a.build_aux_trace(t, env["publics"], env["aux_inputs"], randomness[: a.num_randomness])
                )
    with span("commit to aux traces"):
        tree = commit_traces(
            [aux_pairs[i][0] for i in lay.order], lay.params.log_blowup, hash=lay.params.lmcs_hash()
        )
    channel.send_commitment(tree.root_dev())
    aux_values = [aux_pairs[i][1] for i in lay.order]
    for vals in aux_values:
        channel.send_ext_slice(vals)
    env.update(
        aux_tree=tree, aux_values=aux_values, randomness=_ext_stack(randomness, env["publics"].device),
        alpha=channel.sample_ext(), beta=channel.sample_ext(),
    )


def stage_quotient(lay: ProofLayout, channel, env: dict) -> None:
    """Per-AIR quotient evaluation + Horner accumulation under lifting,
    the quotient commitment and the OOD point z."""
    main_tree, aux_tree, pp_tree = env["main_tree"], env["aux_tree"], env["pp_tree"]
    rand_d, aux_values = env["randomness"], env["aux_values"]
    mesh = main_tree.mesh
    acc = None
    for k, i in enumerate(lay.order):
        air = lay.airs[i]
        with span("evaluate constraints", instance=k, air=type(air).__name__):
            dom = lay.domains[k]
            q = evaluate_quotient(
                air,
                dom,
                main_tree.matrices[k],
                aux_tree.matrices[k] if air.aux_width else None,
                lay.log_ds[k],
                env["alpha"],
                env["publics"],
                rand_d[: air.num_randomness],
                aux_values[k],
                pp_tree.matrices[lay.pp_for_air[i]] if air.preprocessed_width else None,
                mesh,
            )
            if lay.log_ds[k] < lay.log_d:
                q = upsample_evals(q, dom.lde_shift, lay.log_d - lay.log_ds[k], mesh)
            if acc is None:
                acc = q
            else:
                acc = _accumulate_step(
                    (dom.trace_height << lay.log_d) // acc.shape[0], acc, q, env["beta"], mesh
                )
    with span("commit to quotient poly chunks"):
        tree = commit_quotient(
            acc, lay.max_domain, lay.log_d, lay.params.log_blowup, hash=lay.params.lmcs_hash(), mesh=mesh
        )
    channel.send_commitment(tree.root_dev())
    z = channel.sample_ext()
    channel.check("ood point outside domains", _ood_valid_flag(lay.max_domain, z))
    env.update(quotient_tree=tree, z=z)


def opened_trees(env: dict) -> list:
    """The committed trees in opening order: [preprocessed?, main, aux,
    quotient] (prover/mod.rs:552-554)."""
    pp = [env["pp_tree"]] if env["pp_tree"] is not None else []
    return pp + [env["main_tree"], env["aux_tree"], env["quotient_tree"]]


def stage_open(lay: ProofLayout, channel, env: dict) -> None:
    """PCS opening at [z, z·ω_H] up to the query indices: OOD claims, DEEP
    quotient, every FRI round, the PoW grinds."""
    z = env["z"]
    z_next = F.ext_mul_base(z, F.const(lay.max_domain.trace_generator, device=z.device))
    with span("open"):
        env["fri_trees"], env["idx"] = pcs.open_with_channel(
            lay.params, lay.max_domain, opened_trees(env), [z, z_next], channel
        )


#: the stages in transcript order, by the name of their fused phase
STAGES = (("main", stage_main), ("aux", stage_aux), ("quotient", stage_quotient), ("open", stage_open))


def prove(
    params: PcsParams,
    statement: Statement,
    traces: list,
    challenger: DuplexChallenger,
    preprocessed=None,
    device="cuda",
    fused: bool | None = None,
) -> StarkOutput:
    """Prove a multi-AIR statement on ``device``. ``traces[i]``: numpy u64
    or int64 tensor (n_i, width_i), instance order. The challenger must be
    pre-bound to the protocol parameters.

    ``preprocessed``: the :class:`~.preprocessed.Preprocessed` bundle,
    required exactly when some AIR declares preprocessed columns. Its
    commitment is observed into Fiat-Shamir before the statement
    (prover/mod.rs:282-285) but never enters the transcript: the verifier
    holds it as trusted setup input.

    ``fused``: whether the proof goes through :func:`~.fused.prove_fused`,
    which keeps the phases of the proof's shape: on the card their CUDA
    graphs, captured at the shape's second proof and replayed from then
    on. None leaves it to :func:`~.fused.use_fused`: fused on the card
    (also under an NCCL mesh), not on the CPU nor on the card under a gloo
    mesh. Otherwise the phases run once, eagerly, and nothing is kept. Both
    give the same bytes."""
    from .fused import prove_eager, prove_fused, use_fused

    run = prove_fused if use_fused(device, fused) else prove_eager
    return run(params, statement, traces, challenger, preprocessed, device)


def finish_proof(lay: ProofLayout, env: dict, idx_host, channel) -> StarkOutput:
    """The host tail after the transcript readback: the query openings."""
    mask = (1 << lay.max_domain.log_lde_height) - 1
    idx_raw = [int(v) & mask for v in idx_host]
    return _query_phase_and_finalize(
        lay.params, lay.max_domain, opened_trees(env), env["fri_trees"], idx_raw, channel, lay.log_heights,
        env["idx"],
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
