"""Seconds a proof spends in the prover's host steps before its phases (the
program's spans "upload traces": the traces to the card; "bind statement":
the challenger bound to the statement and its publics uploaded; "copy graph
inputs", a replay's: the proof's inputs copied into the graphs' static
ones; ``stark/fused.py``), over the window's proofs. Spans synchronize the
card at their edges, so a step's time includes the device work queued in
it."""

SPANS = ("upload traces", "bind statement", "copy graph inputs")


def read(ctx):
    entries = [ctx["spans"][name] for name in SPANS if name in ctx["spans"]]
    return None if not entries or not ctx["proofs"] else sum(v[0] for v in entries) / ctx["proofs"]
