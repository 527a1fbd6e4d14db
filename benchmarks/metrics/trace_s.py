"""Seconds a proof spends executing the program and building its trace on
the host (the program's span "execute and trace": ``vm/trace.py``,
``native/trace_gen.c``), over the window's proofs."""


def read(ctx):
    entry = ctx["spans"].get("execute and trace")
    return None if entry is None or not ctx["proofs"] else entry[0] / ctx["proofs"]
