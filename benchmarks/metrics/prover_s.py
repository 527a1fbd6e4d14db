"""Seconds a proof spends in the prover's fused phases (the program's spans
"fused phase: <name>", ``stark/fused.py`` over ``stark/prover.py``'s
stages), over the window's proofs. Spans synchronize the card at their
edges, so this is the device work queued inside the phases and the host's
time around it."""

PREFIX = "fused phase: "


def read(ctx):
    entries = [v for k, v in ctx["spans"].items() if k.startswith(PREFIX)]
    return None if not entries or not ctx["proofs"] else sum(v[0] for v in entries) / ctx["proofs"]
