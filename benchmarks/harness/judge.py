"""Judging every proof of a run with the reference, after the window, in
worker processes on the host's spare cores.

Workers are spawned and import only ``benchmarks.reference``; each proof is
judged by :func:`benchmarks.reference.judge` against the claim the
reference works out for itself.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

FLAGS = ("inputs_wrong", "outputs_wrong", "hash_wrong", "rejected")
#: each number a run compares, with its limit: proofs that never came
#: (``missing``) and proofs with each of :data:`FLAGS`, all exact counts
LIMITS = {"missing": 0, **{flag: 0 for flag in FLAGS}}


def _judge_one(args) -> dict:
    from benchmarks import reference

    return reference.judge(*args)


def judge_all(proofs: list, program: dict, params: dict, workers: int | None = None) -> list:
    """``[{"inputs_wrong", "outputs_wrong", "hash_wrong", "rejected", "why"}]``
    for ``proofs``, a list of ``(proof bytes, stack inputs)``."""
    if not proofs:
        return []
    from benchmarks import reference

    digest = reference.family(program).program_hash(program)
    jobs = [(data, program, params, inputs, digest) for data, inputs in proofs]
    if workers is None:
        workers = max(1, min(len(jobs), os.cpu_count() or 1))
    if workers == 1:
        return [_judge_one(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return list(pool.map(_judge_one, jobs))
