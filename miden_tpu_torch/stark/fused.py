"""Phase-fused prover: a proof as five phases, each one CUDA graph on the card
(the counterpart of ``miden_tpu/stark/fused.py``).

The eager prover issues hundreds of thousands of small launches (the field
arithmetic of the aux builders, the OOD claims, the FRI rounds, the
challenger) and the host's dispatch of them, not the card, sets its time.
Here the pipeline runs as five phases with no host work between them:

  1. ``main``:     main-trace LDE + LMCS commit
  2. ``aux``:      randomness → device aux (LogUp) builders → aux commit → α, β
  3. ``quotient``: constraint evaluation + Horner accumulation + quotient
                   commit → z
  4. ``open``:     OOD claims, DEEP quotient, every FRI round, the PoW
                   grinds, query-index sampling
  5. ``final``:    transcript digest + ONE flat payload for a single readback

Each phase is a stage of :mod:`.prover` (``STAGES``), the same code for
every proof. The device challenger threads through the phases as
``(state (12,), ibuf (k,), obuf_n)``: ``obuf`` is ``state[:8]`` whenever it
is not empty, so the sponge state passes losslessly from phase to phase.
The transcript kinds and labels of a phase are fixed by the statement's
shape. Binding the statement into the challenger runs eagerly before the
first phase; the host tail after the readback (the gathers at the query
indices, the second readback, the hint assembly of
``_query_phase_and_finalize``) runs eagerly after the last.

:func:`prove_eager` runs the phases once, eagerly, and keeps nothing: the
path of :func:`~.prover.prove` where :func:`use_fused` does not hold.
:func:`prove_fused` keeps a :class:`FusedPlan` for the proof's shape
(:func:`shape_key`). On the card the first proof of a key runs the phases
eagerly, as :func:`prove_eager` does: it is the warm-up (every kernel
library is loaded, every launch setting and constant table made), and its
output is the proof. The second captures all five phases into CUDA graphs
sharing one memory pool and replays them; later proofs only replay. The
graphs of one key are kept at a time: a new key frees the old key's graphs
and pool (:func:`release`). Data enters a graph only through its static
inputs, copied in before each replay: the traces, the bound challenger
state, the publics, the aux inputs and the preprocessed tree. A phase that
cannot be captured raises :class:`FusedCaptureError`; nothing falls back to
the eager path. On the CPU every proof of a plan runs the phases eagerly on
the plan's layout.

A replay adds to the kernels' launch counts the launches their wrappers
made in the graph's capture, once the graph's own kernel nodes, read back
from it (:func:`~..utils.cuda.graph_kernel_nodes`), were found to run each
kernel's device function exactly that many times; a capture where they
differ raises.

``miden_tpu`` splits its phases further above 2^19 rows (``fused_fine_log_h``)
for its compile service and a 16 GB chip; an 80 GB card holds vm-fib-18's
whole proof (12.067 GiB at its peak), so the port keeps the five phases.
"""

from __future__ import annotations

import time

import torch

from ..dist.context import active_mesh
from ..field import goldilocks as F
from ..merkle import lmcs
from ..transcript.device_challenger import RATE, DeviceChallenger, DeviceProverChannel, transcript_payload
from ..utils import cuda
from ..utils.tracing import span
from . import prover as P

#: the phases in transcript order: the prover's stages, then the payload
PHASES = P.STAGES + (("final", None),)

_PLAN = None  # the FusedPlan of the last fused proof's shape


class FusedCaptureError(RuntimeError):
    """A phase of the fused prover could not be captured into a CUDA graph."""


def use_fused(device="cuda", fused: bool | None = None) -> bool:
    """Whether :func:`~.prover.prove` takes the fused path: ``fused`` when
    given, else on the card and not on the CPU. Never under an active
    :func:`~..dist.context.use_mesh` (a gloo group cannot be captured); asking
    for it there raises."""
    if active_mesh() is not None:
        if fused:
            raise ValueError("the fused prover does not run under a mesh")
        return False
    if fused is not None:
        return bool(fused)
    return torch.device(device).type == "cuda"


def cached_plan():
    """The :class:`FusedPlan` of the last fused proof's shape, or None."""
    return _PLAN


def release() -> None:
    """Drop the cached plan and the constant tables; a captured plan's
    graphs and memory pool go back to the card."""
    global _PLAN
    plan, _PLAN = _PLAN, None
    F.clear_tables()
    if plan is not None and plan.pool is not None:
        del plan
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def shape_key(lay: P.ProofLayout, inputs: dict, obuf_n: int) -> tuple:
    """What a proof's graphs depend on besides their inputs' values: the
    AIRs' classes and widths, the log heights, the parameters, the
    preprocessed tree's shapes, the shapes of the other inputs (the publics,
    the aux inputs, the bound challenger's state and input buffer), the
    challenger's output count and the device."""
    pp = None
    tree = inputs["pp_tree"]
    if tree is not None:
        pp = (
            tuple(tuple(m.shape) for m in tree.matrices),
            tuple(tuple(layer.shape) for layer in tree.layers),
            tuple(sorted(lay.pp_for_air.items())),
        )
    return (
        tuple((type(a), a.width, a.aux_width, a.preprocessed_width) for a in lay.airs),
        tuple(lay.log_heights),
        lay.params,
        pp,
        *(tuple(inputs[k].shape) for k in ("publics", "aux_inputs", "state", "ibuf")),
        obuf_n,
        str(inputs["state"].device),
    )


def _prepare(params, statement, traces, challenger, preprocessed, device) -> tuple:
    """The proof's layout, its inputs on ``device`` (the tensors the phases
    read) and the bound challenger's output count."""
    traces = [P._as_device(t, device) for t in traces]
    lay = P.ProofLayout.of(params, statement, traces, preprocessed)
    dch = P.bind_statement(statement, challenger, preprocessed, lay.log_heights, device)
    publics, aux_inputs = P.statement_tensors(statement, device)
    inputs = {
        "traces": traces, "publics": publics, "aux_inputs": aux_inputs,
        "pp_tree": preprocessed.tree if preprocessed is not None else None,
        "state": dch.state, "ibuf": dch.ibuf,
    }
    return lay, inputs, dch.obuf_n


class _Run:
    """One pass over the phases: the stages' environment (the inputs, then
    every stage's outputs) and the transcript entries and checks of every
    phase, in order."""

    def __init__(self, lay: P.ProofLayout, inputs: dict, obuf_n: int):
        self.lay = lay
        self.env = dict(inputs)
        self.entries: list = []  # ("f" | "c", device tensor)
        self.checks: list = []  # (label, device bool)
        self.obuf_n = obuf_n

    def phase(self, stage) -> None:
        """One phase: rebuild the challenger from the threaded triple, run
        the stage (``None``: the final payload), keep its entries, checks
        and the triple it leaves."""
        env = self.env
        dch = DeviceChallenger(env["state"], env["ibuf"])
        if self.obuf_n:
            dch.obuf = dch.state[:RATE]
            dch.obuf_n = self.obuf_n
        channel = DeviceProverChannel(dch)
        if stage is None:
            env["payload"] = transcript_payload(self.entries, dch.finalize(), env["idx"], self.checks)
        else:
            stage(self.lay, channel, env)
        self.entries += channel._entries
        self.checks += channel._checks
        env["state"], env["ibuf"] = dch.state, dch.ibuf
        self.obuf_n = dch.obuf_n

    def finish(self) -> P.StarkOutput:
        """The readback of the final payload and the host tail."""
        with span("transcript readback"):
            host = F.to_numpy(self.env["payload"])
        channel = DeviceProverChannel(None)
        channel._entries, channel._checks = self.entries, self.checks
        idx_host = channel.read_back(host, self.env["idx"].numel())
        return P.finish_proof(self.lay, self.env, idx_host, channel)


def run_phases(lay: P.ProofLayout, inputs: dict, obuf_n: int) -> _Run:
    """The five phases, eagerly, one span each."""
    run = _Run(lay, inputs, obuf_n)
    for name, stage in PHASES:
        with span(f"fused phase: {name}"):
            run.phase(stage)
    return run


def _static_like(inputs: dict) -> dict:
    """Empty tensors of the inputs' shapes, on their device: a graph's
    static inputs."""
    tree = inputs["pp_tree"]
    if tree is not None:
        tree = lmcs.LmcsTree(
            matrices=[torch.empty_like(m) for m in tree.matrices], heights=list(tree.heights),
            widths=list(tree.widths), layers=[torch.empty_like(layer) for layer in tree.layers],
        )
    out = {k: torch.empty_like(inputs[k]) for k in ("publics", "aux_inputs", "state", "ibuf")}
    return {**out, "traces": [torch.empty_like(t) for t in inputs["traces"]], "pp_tree": tree}


def _flat(inputs: dict) -> list:
    tree = inputs["pp_tree"]
    pp = [] if tree is None else tree.matrices + tree.layers
    return [*inputs["traces"], *pp, *(inputs[k] for k in ("publics", "aux_inputs", "state", "ibuf"))]


class _Phase:
    def __init__(self, name: str, stage):
        self.name = name
        self.stage = stage  # a stage of the prover; None for "final"
        self.graph = None
        self.launches = None  # cuda.LaunchLog: the launches each replay makes
        self.stats = None  # nodes, launches, capture, node read and instantiate seconds


class FusedPlan:
    """The phases of one proof shape and, on the card once captured, their
    graphs, static inputs and the run whose outputs the replays rewrite."""

    def __init__(self, key: tuple, lay: P.ProofLayout, obuf_n: int, device):
        self.key = key
        self.lay = lay
        self.obuf_n = obuf_n
        self.device = torch.device(device)
        self.calls = 0
        self.phases = [_Phase(name, stage) for name, stage in PHASES]
        self.pool = None
        self.inputs = None  # the graphs' static inputs, once captured
        self.run = None  # the captured run: its env holds the graphs' outputs

    @property
    def captured(self) -> bool:
        return self.pool is not None

    def prove(self, inputs: dict) -> _Run:
        """Run the five phases on ``inputs``: eagerly on the CPU and at a
        key's first proof on the card, else from the graphs (captured at
        the second)."""
        self.calls += 1
        if self.device.type != "cuda" or self.calls == 1:
            return run_phases(self.lay, inputs, self.obuf_n)
        if not self.captured:
            self._capture(inputs)
        for dst, src in zip(_flat(self.inputs), _flat(inputs)):
            dst.copy_(src)
        for ph in self.phases:
            with span(f"fused phase: {ph.name}"):
                ph.graph.replay()
                ph.launches.replay()
        return self.run

    def _capture(self, inputs: dict) -> None:
        """Capture every phase, in order, into one memory pool, reading the
        static inputs."""
        self.inputs = _static_like(inputs)
        self.pool = torch.cuda.graph_pool_handle()
        self.run = _Run(self.lay, self.inputs, self.obuf_n)
        for ph in self.phases:
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept to read its nodes
            t0 = time.perf_counter()
            try:
                with cuda.recording_launches() as log:
                    with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                        self.run.phase(ph.stage)
                t1 = time.perf_counter()
                nodes, per_kernel = cuda.graph_kernel_nodes(graph)
                if per_kernel != log.per_kernel():
                    raise cuda.KernelError(
                        f"the graph's kernel nodes {_named(per_kernel)} differ from the launches "
                        f"its capture made {_named(log.per_kernel())}"
                    )
                t2 = time.perf_counter()
                graph.instantiate()
            except Exception as exc:
                release()
                raise FusedCaptureError(
                    f"fused phase {ph.name!r} could not be captured: {type(exc).__name__}: {exc}"
                ) from exc
            ph.graph, ph.launches = graph, log
            ph.stats = {
                "nodes": nodes, "launches": sum(per_kernel.values()), "capture_s": t1 - t0,
                "read_s": t2 - t1, "instantiate_s": time.perf_counter() - t2,
            }

    def phase_stats(self) -> dict:
        """``{phase: {nodes, launches, capture_s, read_s, instantiate_s}}``
        once captured, else {}: the graph's nodes, its kernel nodes of the
        port's kernels, and the seconds of its capture, of reading its nodes
        and of its instantiation."""
        return {ph.name: ph.stats for ph in self.phases if ph.stats is not None}


def _named(per_kernel: dict) -> dict:
    return {k.symbol: n for k, n in per_kernel.items()}


def prove_eager(params, statement, traces, challenger, preprocessed=None, device="cuda") -> P.StarkOutput:
    """:func:`~.prover.prove` as the five phases run once, eagerly; no plan
    is made or kept."""
    device = torch.device(device)
    return run_phases(*_prepare(params, statement, traces, challenger, preprocessed, device)).finish()


def prove_fused(params, statement, traces, challenger, preprocessed=None, device="cuda") -> P.StarkOutput:
    """:func:`~.prover.prove` as the five phases of the plan of the proof's
    shape (made at the shape's first proof, which drops any other); the
    same bytes."""
    global _PLAN
    device = torch.device(device)
    lay, inputs, obuf_n = _prepare(params, statement, traces, challenger, preprocessed, device)
    key = shape_key(lay, inputs, obuf_n)
    if _PLAN is None or _PLAN.key != key:
        release()
        _PLAN = FusedPlan(key, lay, obuf_n, device)
    return _PLAN.prove(inputs).finish()
