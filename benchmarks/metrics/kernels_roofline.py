"""The port's kernels' share of their roofline: over the profiled proofs,
the sum of each launch's bound (the larger of its bytes over the HBM rate
and its 32-bit multiplies over the card's multiply rate, from the frozen
work counts of ``roofline/``, by the launch's shape alone) over the sum of
the launches' device time.

A replay repeats its shape's eager proof launch for launch, so a proof's
launches are the eager warm-up's, shape by shape. Kernels without a work
count are left out of both sums. Where the profile does not hold each
kernel as often as that many proofs launch it, launches and shapes cannot
be paired, and there is nothing to read.
"""

from benchmarks.harness.peaks import bound_s


def read(ctx):
    p, peaks = ctx["profile"], ctx["peaks"]
    if p is None or peaks is None or not p.proofs or not ctx["launches"]:
        return None
    seen: dict = {}
    for s, e, name, kind in p.device:
        kernel = ctx["kernel_of"](name) if kind == "kernel" else None
        if kernel is not None:
            entry = seen.setdefault(kernel, [0, 0])
            entry[0] += e - s
            entry[1] += 1
    bound, spent = 0.0, 0.0
    for kernel, shapes in ctx["launches"].items():
        if seen.get(kernel, [0, 0])[1] != p.proofs * sum(shapes.values()):
            return None
        works = [(ctx["work_of"](kernel, key), n) for key, n in shapes.items()]
        if any(w is None for w, _ in works):
            continue
        bound += p.proofs * sum(n * bound_s(b, m, peaks) for (b, m), n in works)
        spent += seen[kernel][0] / 1e9
    return 100.0 * bound / spent if spent > 0 else None
