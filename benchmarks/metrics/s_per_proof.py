"""Seconds per proof: the window's seconds, from its opening to the end of
the proof that crossed its length (after a ``synchronize``), over the
proofs completed in it."""


def read(ctx):
    return ctx["window_s"] / ctx["proofs"] if ctx["proofs"] else None
