"""Phase spans, name-compatible with ``miden_tpu.utils.tracing``.

``span(name)`` marks a pipeline phase ("commit to main traces", "evaluate
constraints", "DEEP reduce + assemble", "FRI round commit", ...). Spans cost
nothing unless a :class:`Recorder` is active (``with Recorder() as rec:``).
While one is, ``torch.cuda.synchronize()`` runs at each span edge on the
card, so a span's time is the device work queued inside it (the prover is
otherwise asynchronous and the time pools in the final readback); a traced
run is therefore never a timed one. While a CUDA graph is captured, spans
neither synchronize nor record: nothing runs then.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .cuda import capturing

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


@contextlib.contextmanager
def span(name: str, **fields):
    """A phase of the pipeline; ``fields`` describe it (rows, bits, ...)."""
    if not _recorders or capturing():
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
