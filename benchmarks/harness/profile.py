"""A profiled stretch of proofs, read straight from the profiler's results.

``torch.profiler`` records the host's operations and the card's kernels,
copies and fills. The events are read from kineto's results directly: the
Python event tree (``key_averages``) of the ~300k device events of one
proof takes minutes to build. A stretch is the span of the host annotation
around the profiled calls, which ends after a ``synchronize``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

ANNOTATION = "benchmark: profiled proofs"
#: host events of the profiler's own bookkeeping, which say nothing of what
#: the program was doing
BOOKKEEPING = frozenset({ANNOTATION, "Activity Buffer Request", "Buffer Flush"})


@dataclass
class Profile:
    """Device events ``(start_ns, end_ns, name, kind)`` (kind: "kernel",
    "memcpy" or "memset") and host events ``(start_ns, end_ns, name)`` inside
    the stretch ``[t0_ns, t1_ns]`` of ``proofs`` proofs."""

    t0_ns: int
    t1_ns: int
    proofs: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def capture(torch, fn, proofs: int) -> Profile:
    """Profile ``fn`` (which makes ``proofs`` proofs) on the host and the
    card, and read the events back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with record_function(ANNOTATION):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    on_card = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    marks = [e for e in events if e.name() == ANNOTATION and e.device_type() != on_card]
    if len(marks) != 1:
        raise RuntimeError(f"the profile holds {len(marks)} annotations of its stretch, not 1")
    t0 = marks[0].start_ns()
    out = Profile(t0, t0 + marks[0].duration_ns(), proofs, wall_s=wall)
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if end <= out.t0_ns or start >= out.t1_ns or e.name() in BOOKKEEPING:
            continue
        if e.device_type() == on_card:
            out.device.append((start, end, e.name(), _kind(e.name())))
        else:
            out.host.append((start, end, e.name()))
    return out


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(p: Profile) -> float:
    """Seconds of the stretch in which some operation ran on the card."""
    spans = merged((max(s, p.t0_ns), min(e, p.t1_ns)) for s, e, _, _ in p.device)
    return sum(e - s for s, e in spans) / 1e9


def idle_gaps(p: Profile, top: int = 10) -> list:
    """The ``top`` longest stretches with nothing running on the card, as
    ``[what the host was doing, seconds]``: the host event that overlaps the
    gap most (the shortest of equals), else "host: no profiled operation"
    (Python between the program's torch calls, such as the trace build)."""
    spans = merged((max(s, p.t0_ns), min(e, p.t1_ns)) for s, e, _, _ in p.device)
    edges = [p.t0_ns] + [x for s, e in spans for x in (s, e)] + [p.t1_ns]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    out = []
    for length, start in gaps:
        end, best = start + length, None
        for hs, he, name in p.host:
            overlap = min(he, end) - max(hs, start)
            if overlap > 0:
                rank = (overlap, -(he - hs))
                if best is None or rank > best[0]:
                    best = (rank, name)
        out.append([best[1][:120] if best else "host: no profiled operation", length / 1e9])
    return out


def device_ops(p: Profile, top: int = 10) -> list:
    """The ``top`` device operations by their summed seconds in the stretch."""
    sums: dict = {}
    for s, e, name, _ in p.device:
        key = name.removeprefix("void ")[:120]
        sums[key] = sums.get(key, 0) + (e - s)
    return [[k, v / 1e9] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]
