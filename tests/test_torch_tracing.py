"""The port's spans (``miden_tpu_torch/utils/tracing.py``) on the CPU: what a
span does with no Recorder and no profiler (nothing), under the profiler
(a host event ``miden: <name>`` with its fields, no synchronize) and under
a Recorder (its totals, no profiler event)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from miden_tpu_torch.utils import tracing
from miden_tpu_torch.utils.tracing import Recorder, span


def _refuse(*args, **kwargs):
    raise AssertionError("called")


@pytest.fixture
def no_annotation(monkeypatch):
    """Any profiler record a span would open raises."""
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)


def _nested_spans() -> None:
    with span("outer", rows=8, air="CoreVmAir"):
        with span("inner"):
            torch.ones(4).add_(1)


def test_span_without_recorder_or_profiler_does_nothing(monkeypatch, no_annotation):
    monkeypatch.setattr(tracing, "_sync", _refuse)
    _nested_spans()


def test_span_under_the_profiler_is_a_host_event_with_its_fields(monkeypatch):
    monkeypatch.setattr(tracing, "_sync", _refuse)  # annotating never synchronizes
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        _nested_spans()
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("miden: ")}
    assert set(events) == {"miden: outer", "miden: inner"}
    outer, inner = events["miden: outer"], events["miden: inner"]
    assert outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()
    assert outer.kwinputs() == {"args": "rows=8, air=CoreVmAir"} and inner.kwinputs() == {}
    # not a user annotation, of which the profiler would make a device event too
    assert not outer.is_user_annotation() and not inner.is_user_annotation()


def test_span_under_a_recorder_keeps_totals_and_makes_no_annotation(no_annotation):
    with Recorder() as rec:
        _nested_spans()
        _nested_spans()
    assert set(rec.totals) == {"outer", "inner"}
    assert rec.totals["outer"][1] == 2 and rec.totals["inner"][1] == 2
    assert rec.totals["outer"][0] >= rec.totals["inner"][0] > 0
    assert set(rec.by_air) == {("outer", "CoreVmAir")} and rec.by_air[("outer", "CoreVmAir")][1] == 2


def test_span_under_both_records_and_annotates():
    with Recorder() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        _nested_spans()
    assert rec.totals["outer"][1] == 1 and rec.totals["inner"][1] == 1
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("miden: outer") == 1 and names.count("miden: inner") == 1


def test_span_during_a_capture_does_nothing(monkeypatch, no_annotation):
    monkeypatch.setattr(tracing, "capturing", lambda: True)
    monkeypatch.setattr(tracing, "_sync", _refuse)
    with Recorder() as rec, profile(activities=[ProfilerActivity.CPU]):
        _nested_spans()
    assert rec.totals == {}


def test_span_passes_an_exception_on_and_still_records():
    with Recorder() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with span("failing"):
                raise ValueError("inside")
    assert rec.totals["failing"][1] == 1
    assert [e.name() for e in prof.profiler.kineto_results.events()].count("miden: failing") == 1
