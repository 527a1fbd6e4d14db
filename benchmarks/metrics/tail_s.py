"""Seconds a proof spends in the prover's host tail after its phases (the
program's spans "transcript readback": the final payload read back and the
transcript replayed from it, ``stark/fused.py``; "query phase": the
openings gathered at the query indices, read back and assembled into the
proof's bytes, ``stark/prover.py``), over the window's proofs."""

SPANS = ("transcript readback", "query phase")


def read(ctx):
    entries = [ctx["spans"][name] for name in SPANS if name in ctx["spans"]]
    return None if not entries or not ctx["proofs"] else sum(v[0] for v in entries) / ctx["proofs"]
