"""Device seconds a proof spends in the port's own kernels (``csrc/``: K1,
K2, K3, R1, R2, Q1), told apart by their device functions' names, over the
profiled proofs."""


def read(ctx):
    p = ctx["profile"]
    if p is None or not p.proofs:
        return None
    ns = [e - s for s, e, name, kind in p.device if kind == "kernel" and ctx["kernel_of"](name)]
    return sum(ns) / 1e9 / p.proofs if ns else None
