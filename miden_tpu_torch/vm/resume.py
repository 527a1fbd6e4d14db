"""Interpreter pause/resume: cycle-budgeted stepwise execution.

Covers the reference's FastProcessor stepping surface
(processor/src/fast/step.rs: ``BreakReason`` / ``ResumeContext`` —
execute up to a cycle budget, surface the paused interpreter for
inspection, continue where it stopped). The reference suspends its
explicit step loop; this interpreter is a recursive MAST walker, so the
suspension point is implemented by parking the walker on a worker
thread at the ``_tick`` boundary — the controller thread gets back a
:class:`ResumeContext` whose ``processor`` is genuinely mid-execution
(stack, memory, clk, deferred state all inspectable), and ``resume()``
hands the walker a new budget. The context is in-memory (the
reference's ResumeContext is too); it is not a serializable checkpoint.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .processor import ExecutionError, Processor


class BreakReason:
    """Why a stepwise execution stopped (fast/step.rs BreakReason)."""

    CYCLE_BUDGET = "cycle_budget"  # paused: budget exhausted, resumable
    FINISHED = "finished"  # program halted; ``output`` is set
    ERROR = "error"  # ExecutionError raised; ``error`` is set
    CANCELLED = "cancelled"  # cancel() requested


class _Cancelled(ExecutionError):
    pass


@dataclass
class ResumeContext:
    """A paused (or finished) stepwise execution."""

    processor: Processor
    reason: str = BreakReason.CYCLE_BUDGET
    output: object = None  # ExecutionOutput once FINISHED
    error: Exception | None = None
    _limit: int = 0
    _cancel: bool = False
    _resume_evt: threading.Event = field(default_factory=threading.Event)
    _paused_evt: threading.Event = field(default_factory=threading.Event)
    _thread: threading.Thread | None = None

    @property
    def clk(self) -> int:
        return self.processor.clk

    @property
    def done(self) -> bool:
        return self.reason in (
            BreakReason.FINISHED,
            BreakReason.ERROR,
            BreakReason.CANCELLED,
        )

    # -- worker side -------------------------------------------------------

    def _hook(self) -> None:
        """Called by Processor._tick on the worker thread."""
        if self._cancel:
            raise _Cancelled("stepwise execution cancelled")
        if self.processor.clk >= self._limit:
            self.reason = BreakReason.CYCLE_BUDGET
            self._paused_evt.set()
            self._resume_evt.wait()
            self._resume_evt.clear()
            if self._cancel:
                raise _Cancelled("stepwise execution cancelled")

    def _run(self) -> None:
        try:
            self.output = self.processor.execute()
            self.reason = BreakReason.FINISHED
        except _Cancelled:
            self.reason = BreakReason.CANCELLED
        except ExecutionError as exc:
            self.reason = BreakReason.ERROR
            self.error = exc
        finally:
            self._paused_evt.set()

    # -- controller side ---------------------------------------------------

    def _start(self, budget: int) -> "ResumeContext":
        self._limit = budget
        self.processor._step_hook = self._hook
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._wait()
        return self

    def _wait(self) -> None:
        self._paused_evt.wait()
        self._paused_evt.clear()

    def resume(self, cycles: int) -> str:
        """Continue execution for up to ``cycles`` more cycles; returns
        the new break reason."""
        if self.done:
            return self.reason
        self._limit = self.processor.clk + cycles
        self._resume_evt.set()
        self._wait()
        return self.reason

    def cancel(self) -> None:
        """Abort a paused execution; the worker unwinds and the context
        transitions to CANCELLED."""
        if self.done:
            return
        self._cancel = True
        self._resume_evt.set()
        self._wait()

    def finish(self, max_cycles: int | None = None):
        """Run to completion (bounded by the processor's own max_cycles
        unless ``max_cycles`` is given); returns the ExecutionOutput."""
        budget = (
            max_cycles
            if max_cycles is not None
            else self.processor.max_cycles - self.processor.clk
        )
        while not self.done:
            self.resume(budget)
        if self.reason == BreakReason.ERROR:
            raise self.error
        if self.reason == BreakReason.CANCELLED:
            raise ExecutionError("stepwise execution cancelled")
        return self.output


def execute_stepwise(
    program,
    stack_inputs=None,
    advice=None,
    cycles: int = 1024,
    event_handlers=None,
    **kwargs,
) -> ResumeContext:
    """Start a pausable execution: runs up to ``cycles`` cycles and
    returns the (possibly already finished) :class:`ResumeContext`.

    Mirrors fast/step.rs ``execute_with_break``: the returned context
    either FINISHED (``output`` holds the ExecutionOutput) or paused at
    CYCLE_BUDGET with the live processor inspectable."""
    from .processor import AdviceProvider, StackInputs

    proc = Processor(
        program,
        stack_inputs
        if isinstance(stack_inputs, StackInputs) or stack_inputs is None
        else StackInputs(stack_inputs),
        advice or AdviceProvider(),
        event_handlers=event_handlers,
        **kwargs,
    )
    return ResumeContext(proc)._start(cycles)
