"""Set-up seconds: from the process's start to the window's opening
(imports, the kernel libraries, assembling, the warm-up proofs: on the card
the eager proof and the call that captures the shape's graphs)."""


def read(ctx):
    return ctx["setup_s"]
