"""The card memory the process holds for its proofs: the peak of
``torch.cuda.max_memory_reserved()`` over the window (reset as it opens),
in GiB. Reserved, not allocated: a replay runs in the CUDA-graph pool,
which the allocated count misses."""


def read(ctx):
    return ctx["peak_reserved"] / 2**30 if ctx["peak_reserved"] else None
