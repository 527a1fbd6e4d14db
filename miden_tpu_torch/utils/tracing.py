"""Phase spans, name-compatible with ``miden_tpu.utils.tracing``.

``span(name)`` marks a pipeline phase ("commit to main traces", "evaluate
constraints", "DEEP reduce + assemble", "FRI round commit", ...) or a host
step around the phases ("execute and trace", "upload traces", "bind
statement", "transcript readback", "query phase", ...). A span does two
things, each only while what it serves is active, and costs one check and
nothing else while neither is:

- While a :class:`Recorder` is active (``with Recorder() as rec:``), it
  records its time. ``torch.cuda.synchronize()`` runs at each span edge on
  the card, so a span's time is the device work queued inside it (the
  prover is otherwise asynchronous and the time pools in the final
  readback); a recorded run is therefore never a timed one.
- While ``torch.profiler`` records, it opens a host event ``miden: <name>``
  on the profiler's clock, the one the card's kernels, copies and fills are
  on, so a stretch in which the card is idle can be put down to the step
  the host was in. Annotating never synchronizes.

While a CUDA graph is captured, spans do neither: nothing runs then.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

from .cuda import capturing

#: what the profiler's host events of the program's spans are named by
ANNOTATION_PREFIX = "miden: "

_recorders: list = []


class Recorder:
    """Collects ``{span name: [total seconds, count]}`` while active; nested
    spans count inside their parents as well as on their own. Spans with an
    ``air`` field are also summed per AIR in ``by_air``
    (``{(span name, air): [total seconds, count]}``)."""

    def __init__(self):
        self.totals: dict = {}
        self.by_air: dict = {}

    def __enter__(self) -> "Recorder":
        _recorders.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _recorders.remove(self)

    def add(self, name: str, seconds: float, air: str | None = None) -> None:
        _accumulate(self.totals, name, seconds)
        if air is not None:
            _accumulate(self.by_air, (name, air), seconds)


def _accumulate(table: dict, key, seconds: float) -> None:
    entry = table.setdefault(key, [0.0, 0])
    entry[0] += seconds
    entry[1] += 1


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _annotation(name: str, fields: dict):
    """The profiler's host event of a span, its fields as one args string
    (``rows=262144, air=CoreVmAir``), which the profiler keeps where it
    records inputs (``record_shapes=True``). A function-scope record, not
    ``record_function``: that one is a user annotation, of which the
    profiler also makes a device event over the kernels launched inside it,
    and device events are what the card's busy time is read from."""
    args = {"args": ", ".join(f"{k}={v}" for k, v in fields.items())} if fields else {}
    return torch._C._profiler._RecordFunctionFast(ANNOTATION_PREFIX + name, [], args)


@contextlib.contextmanager
def span(name: str, **fields):
    """A phase of the pipeline or a host step; ``fields`` describe it (rows,
    bits, instance, air, ...). A :class:`Recorder` keeps the time and
    ``air``; the profiler's event ``miden: <name>`` carries every field in
    its args."""
    annotate = _profiler._is_profiler_enabled
    if not (_recorders or annotate) or capturing():
        yield
        return
    with _annotation(name, fields) if annotate else contextlib.nullcontext():
        if not _recorders:
            yield
            return
        _sync()
        t0 = time.perf_counter()
        try:
            yield
            _sync()
        finally:
            dt = time.perf_counter() - t0
            for rec in _recorders:
                rec.add(name, dt, fields.get("air"))
