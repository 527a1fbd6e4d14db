"""Device seconds a proof spends in kernels that are not the port's:
PyTorch's own, which run the field arithmetic written in plain torch
(``field/goldilocks.py``, ``vm/constraints/aux_numeric.py``,
``stark/pcs.py``), over the profiled proofs."""


def read(ctx):
    p = ctx["profile"]
    if p is None or not p.proofs:
        return None
    ns = [e - s for s, e, name, kind in p.device if kind == "kernel" and not ctx["kernel_of"](name)]
    return sum(ns) / 1e9 / p.proofs if ns else None
