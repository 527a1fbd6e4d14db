"""Share of the card's idle time, over the profiled stretch, in which the
host is inside none of the program's spans (its profiler events "miden:
<name>", ``miden_tpu_torch/utils/tracing.py``): the idle time that no span
can be blamed for, the measurement's own blind spot on the device's clock.
Nothing to read where the profile holds no such event (a program whose
spans do not reach the profiler)."""

from benchmarks.harness.profile import merged

PREFIX = "miden: "


def read(ctx):
    p = ctx["profile"]
    if p is None:
        return None
    spans = merged(_clip(p, s, e) for s, e, name in p.host if name.startswith(PREFIX))
    if not spans:
        return None
    idle = _idle(p)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return 0.0
    return 100.0 * (total - _overlap(idle, spans)) / total


def _clip(p, s, e) -> tuple:
    return max(s, p.t0_ns), min(e, p.t1_ns)


def _idle(p) -> list:
    """The stretches of ``[t0_ns, t1_ns]`` with nothing running on the card."""
    busy = merged(_clip(p, s, e) for s, e, _, _ in p.device)
    edges = [p.t0_ns] + [x for s, e in busy for x in (s, e)] + [p.t1_ns]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def _overlap(a, b) -> int:
    """Nanoseconds shared by two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
