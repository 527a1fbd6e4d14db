"""CPU tests of the readers of the program's spans that the prover's host
steps and the profiler's idle stretches are measured by: ``bind_s``,
``tail_s`` and ``idle_unspanned_pct``, on synthetic runs.

    python -m pytest benchmarks -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.harness import spec  # noqa: E402
from benchmarks.harness.profile import Profile  # noqa: E402

BIND = ("upload traces", "bind statement", "copy graph inputs")
TAIL = ("transcript readback", "query phase")


def read(name: str, **ctx):
    return spec.metric_reader(name)(ctx)


@pytest.mark.parametrize("name,spans", [("bind_s", BIND), ("tail_s", TAIL)])
def test_host_step_seconds_are_per_proof(name, spans):
    totals = {s: [0.5 * (i + 1), 4] for i, s in enumerate(spans)}
    totals["fused phase: main"] = [9.0, 4]  # another span is not read
    want = sum(0.5 * (i + 1) for i in range(len(spans))) / 4
    assert read(name, spans=totals, proofs=4) == pytest.approx(want)
    # an eager proof has no "copy graph inputs": the others still count
    assert read(name, spans={spans[0]: [1.0, 2]}, proofs=2) == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["bind_s", "tail_s"])
def test_host_step_seconds_without_their_spans_are_not_read(name):
    assert read(name, spans={"execute and trace": [1.0, 2]}, proofs=2) is None
    assert read(name, spans={}, proofs=0) is None


def _profile(host, device=((100, 200), (300, 400))) -> Profile:
    """A stretch of [0, 500] ns whose card is busy at ``device``: idle over
    [0, 100], [200, 300] and [400, 500], 300 ns in all."""
    return Profile(0, 500, 1, device=[(s, e, "kernel", "kernel") for s, e in device], host=list(host))


def idle_unspanned(p: Profile):
    return read("idle_unspanned_pct", profile=p)


def test_idle_under_spans_is_not_unspanned():
    spans = [(0, 150, "miden: execute and trace"), (150, 350, "miden: fused phase: main"),
             (350, 500, "miden: query phase")]
    assert idle_unspanned(_profile(spans)) == 0.0


def test_idle_under_no_span_is_all_unspanned():
    # the spans cover only busy time
    spans = [(100, 200, "miden: fused phase: main"), (300, 400, "miden: fused phase: aux")]
    assert idle_unspanned(_profile(spans)) == pytest.approx(100.0)


def test_idle_partly_under_spans():
    # [0, 50] and [450, 500] of the idle 300 ns lie under no span; nested and
    # overlapping spans count once
    spans = [(50, 450, "miden: outer"), (60, 120, "miden: inner"), (100, 300, "miden: other")]
    assert idle_unspanned(_profile(spans)) == pytest.approx(100.0 * 100 / 300)


def test_a_torch_host_event_over_an_idle_gap_is_no_span():
    host = [(0, 500, "aten::to"), (200, 300, "cudaGraphLaunch"), (0, 100, "miden: execute and trace")]
    assert idle_unspanned(_profile(host)) == pytest.approx(100.0 * 200 / 300)


def test_no_program_span_in_the_profile_is_not_read():
    assert idle_unspanned(_profile([(0, 500, "aten::to")])) is None
    assert read("idle_unspanned_pct", profile=None) is None


def test_a_card_never_idle_leaves_nothing_unspanned():
    p = _profile([(0, 500, "miden: fused phase: main")], device=[(0, 500)])
    assert idle_unspanned(p) == 0.0


def test_spans_and_device_events_are_clipped_to_the_stretch():
    p = Profile(100, 500, 1, device=[(50, 200, "k", "kernel")], host=[(0, 150, "miden: execute and trace")])
    # idle [200, 500], no span over it
    assert idle_unspanned(p) == pytest.approx(100.0)
