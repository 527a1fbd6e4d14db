"""A cell's files, found by the names in ``BENCHMARK.json``: its workload
entry, its configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``) and its metrics' readers (``metrics/<name>.py``)."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    workload: dict  # the entry of BENCHMARK.json's "workloads"
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # the entries of "end_to_end" this cell reports
    per_layer: list  # the entries of "per_layer" this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    ``KeyError`` for a name it does not hold."""
    bench = bench if bench is not None else load_benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    w = entries[0]
    configs = [c for c in bench["configs"] if c["name"] == w["config"]]
    if len(configs) != 1:
        raise KeyError(f"BENCHMARK.json has no configuration {w['config']!r}")
    config = json.loads((ROOT / configs[0]["file"]).read_text())
    return Cell(
        workload=w,
        config=config,
        traffic=load_traffic(w["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def load_traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    return importlib.import_module(f"benchmarks.metrics.{name}").read


def work_of(kernel: str, key: tuple):
    """``(bytes, 32-bit multiplies)`` of one launch of the port's kernel
    ``kernel`` at the shape ``key`` (``roofline/<kernel>.py``), or None where
    it has no work count."""
    try:
        mod = importlib.import_module(f"benchmarks.roofline.{kernel}")
    except ModuleNotFoundError:
        return None
    return mod.work_of(key)
