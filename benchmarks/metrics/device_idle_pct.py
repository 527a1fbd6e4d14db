"""Share of the profiled stretch in which nothing (no kernel, copy or fill)
runs on the card."""

from benchmarks.harness.profile import busy_s


def read(ctx):
    p = ctx["profile"]
    if p is None or p.window_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - busy_s(p) / p.window_s)
