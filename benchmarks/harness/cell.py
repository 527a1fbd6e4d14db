"""One run of one cell: set-up, the measured window, the traced extras, and
the judgement of every proof by the reference.

Set-up assembles the configuration's program and makes the mix's warm-up
proofs (on the card: the shape's eager proof, then the call that captures
its graphs), so that nothing compiles or captures inside the window. The
window is a closed loop with one client: proof after proof, each on fresh
stack inputs from the seed, until the proof that crosses ``seconds``; its
time is read after a ``synchronize``. A traced run records the program's
spans over the window and then profiles a few more proofs. Every proof
(warm-up, window and profiled) is judged after all of that, off the clock.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import traceback

from . import judge, spec
from .peaks import card_state
from .profile import capture, device_ops, idle_gaps
from .traffic import Traffic

#: the top-level module names the process must not hold once the window has
#: closed: JAX, its relatives and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "miden_tpu")


class HarnessError(RuntimeError):
    """The run cannot be measured as the cell asks (no result is printed)."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``miden_tpu_torch`` is not ``miden_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def steal_s() -> float | None:
    """Seconds of CPU time the host's hypervisor gave to others, over all
    CPUs since boot (``/proc/stat``), or None where it is not there."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _launch_shapes(kernels) -> dict:
    return {k.symbol: dict(k.shapes) for k in kernels}


def _per_proof(before: dict, after: dict, proofs: int) -> dict:
    """The launches one proof makes, ``{kernel: {shape: count}}``, from the
    counts before and after ``proofs`` proofs; {} where they do not divide."""
    out = {}
    for kernel, shapes in after.items():
        diff = {key: n - before.get(kernel, {}).get(key, 0) for key, n in shapes.items()}
        diff = {key: n for key, n in diff.items() if n}
        if not diff:
            continue
        if any(n % proofs for n in diff.values()):
            return {}
        out[kernel] = {key: n // proofs for key, n in diff.items()}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, prove=None, workers: int | None = None,
             marks: dict | None = None) -> dict:
    """Run ``cell`` and return its result: ``{"correct", "attempted",
    "failed", "metrics", "device", ["breakdown"], "checks"}`` and, under
    ``"run"``, what the run saw (proof counts, replays, the card).

    ``prove(program, stack_inputs, params)``, when given, stands in for
    ``prove_program`` (a test's broken prover); ``device="cpu"`` runs the
    cell's path on the CPU, for tests at a small size. ``marks`` holds the
    set-up steps already taken (seconds since ``t_start``), to which the
    run adds its own."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from miden_tpu_torch.stark import fused
    from miden_tpu_torch.stark.params import PcsParams
    from miden_tpu_torch.utils import cuda as port_cuda
    from miden_tpu_torch.utils.tracing import Recorder
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import prove_program

    from .. import reference

    on_card = device == "cuda"
    mix = cell.traffic
    params = PcsParams(**cell.config["params"])
    traffic = Traffic(mix, seed)
    if prove is None:
        def prove(program, inputs, params):
            return prove_program(program, inputs, params=params, device=device)

    marks = {**(marks or {}), "imports": time.perf_counter() - t_start}
    if on_card:
        port_cuda.build_all()
    marks["build"] = time.perf_counter() - t_start
    program = assemble(reference.family(cell.config["program"]).masm(cell.config["program"]))
    made = []  # (part, proof or None, stack inputs)
    errors: list = []

    def one(part: str, i: int) -> None:
        inputs = traffic.stack_inputs(part, i)
        try:
            _, proof = prove(program, inputs, params)
        except Exception:  # a proof that never comes is judged as missing
            proof = None
            if not errors:
                log(f"a {part} proof raised:\n{traceback.format_exc()}")
            errors.append(part)
        made.append((part, proof, inputs))

    # -- set-up ---------------------------------------------------------------
    marks["assemble"] = time.perf_counter() - t_start
    for i in range(int(mix["warm_proofs"])):
        one("warm", i)
        marks[f"warm {i}"] = time.perf_counter() - t_start
    plan = fused.cached_plan() if on_card else None
    calls0 = plan.calls if plan is not None else 0
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_reserved()
        torch.cuda.reset_peak_memory_stats()
    shapes0 = _launch_shapes(port_cuda._KERNELS)
    setup_s = time.perf_counter() - t_start

    # -- the window ---------------------------------------------------------------
    state0 = card_state() if on_card else None
    recorder = Recorder() if trace else None
    n0 = len(made)
    with recorder if recorder is not None else contextlib.nullcontext():
        cpu0, steal0 = time.process_time(), steal_s()
        t0 = time.perf_counter()
        ends = []
        while True:
            one("window", len(ends))
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    window_cpu_s, steal1 = time.process_time() - cpu0, steal_s()
    state1 = card_state() if on_card else None
    proofs = len(made) - n0
    window_peak = torch.cuda.max_memory_reserved() if on_card else 0
    launches = _per_proof(shapes0, _launch_shapes(port_cuda._KERNELS), proofs)
    replays = None
    if on_card:
        now = fused.cached_plan()
        replays = now.calls - calls0 if now is plan and plan is not None and plan.captured else 0
        if mix.get("window") == "replay" and replays != proofs:
            raise HarnessError(f"{proofs - replays} of the window's {proofs} proofs were not replays "
                               f"of the shape's captured graphs")
    found = forbidden_modules()
    if found:
        raise HarnessError(f"the process holds {', '.join(found)} once the window has closed")

    # -- traced extras ------------------------------------------------------------
    profile, peaks = None, None
    if trace and on_card:
        from .peaks import card_peaks

        peaks = card_peaks(torch)
        k = int(mix["profiled_proofs"])
        profile = capture(torch, lambda: [one("profiled", j) for j in range(k)], k)

    # -- judgement ------------------------------------------------------------------
    t_judge = time.perf_counter()
    checks, window_failed, judged = _judge(made, errors, cell.config["program"], cell.config["params"], workers)
    judge_s = time.perf_counter() - t_judge
    del made
    correct = proofs > 0 and all(checks[name] <= judge.LIMITS[name] for name in judge.LIMITS)

    # -- metrics --------------------------------------------------------------------
    ctx = {
        "proofs": proofs, "window_s": window_s, "setup_s": setup_s, "peak_reserved": window_peak,
        "spans": dict(recorder.totals) if recorder is not None else {}, "profile": profile,
        "launches": launches, "kernel_of": _kernel_of(port_cuda), "work_of": spec.work_of, "peaks": peaks,
    }
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": proofs,
        "failed": window_failed,
        "metrics": metrics,
        "device": _device(torch, on_card, cell.workload.get("chips", 1), max(setup_peak, window_peak)),
    }
    if profile is not None:
        from .profile import busy_s

        result["device"]["busy_s"] = busy_s(profile)
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": device_ops(profile), "idle_gaps": idle_gaps(profile)}
    result["run"] = {
        "window_proofs": proofs, "replays": replays, "warm_proofs": int(mix["warm_proofs"]),
        "profiled_proofs": profile.proofs if profile is not None else 0, "judged": judged,
        "window_s": window_s, "setup_peak_bytes": setup_peak, "window_peak_bytes": window_peak,
        "power_limit_w": peaks["power_limit_w"] if peaks else None,
        "profiled_wall_s": profile.wall_s if profile is not None else None, "judge_s": judge_s,
        "setup_marks_s": marks, "proof_ends_s": ends, "window_cpu_s": window_cpu_s,
        "window_steal_s": None if steal0 is None or steal1 is None else steal1 - steal0,
        "card_state": [state0, state1],
    }
    result["checks"] = {name: {"value": checks[name], "limit": judge.LIMITS[name]} for name in judge.LIMITS}
    return result


def _judge(made: list, errors: list, program: dict, params: dict, workers) -> tuple:
    """Judge every proof made: ``(checks, window proofs that failed, proofs
    judged)``; ``checks`` holds each number of :data:`judge.LIMITS`."""
    judged = [(part, proof.to_bytes(), inputs) for part, proof, inputs in made if proof is not None]
    verdicts = judge.judge_all([(data, inputs) for _, data, inputs in judged], program, params, workers)
    checks = {"missing": len(errors)}
    for flag in judge.FLAGS:
        checks[flag] = sum(v[flag] for v in verdicts)
    refused = [v["why"] for v in verdicts if v["why"]]
    if refused:
        log(f"{len(refused)} proofs were refused; the first: {refused[0]}")
    failed = errors.count("window") + sum(
        1 for (part, *_), v in zip(judged, verdicts) if part == "window" and any(v[f] for f in judge.FLAGS))
    return checks, failed, len(judged)


def _kernel_of(port_cuda):
    def kernel_of(name: str):
        kernel = port_cuda.kernel_named(name)
        return None if kernel is None else kernel.symbol

    return kernel_of


def _device(torch, on_card: bool, chips: int, peak: int) -> dict:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(chips),
            "memory_peak_bytes": int(peak)}
