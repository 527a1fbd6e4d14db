"""One reader per per-layer metric, found by the metric's name in
``BENCHMARK.json``: ``read(ctx)`` returns the metric's value, or None where
the run has nothing to read it from (the harness then leaves it out).

``ctx`` (built by ``harness/cell.py``) holds ``proofs`` (the window's),
``spans`` (the program's span totals over the window, ``{name: [seconds,
count]}``), ``profile`` (a ``harness.profile.Profile`` of proofs after the
window, or None), ``launches`` (the port's kernel launches of one proof,
``{kernel: {shape: count}}``), ``kernel_of`` (the port's kernel of a device
function's name, or None), ``work_of`` (a kernel's work count from
``roofline/``, or None) and ``peaks`` (``harness.peaks.card_peaks``)."""
