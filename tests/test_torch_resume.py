"""The port's pause/resume (``miden_tpu_torch.vm.resume``) ≡ ``miden_tpu``'s.

The cases of ``tests/test_resume.py`` on the port, and parity: at the same
cycle budgets both packages pause at the same ``clk`` with the same stack,
and finish with the same output, with the default (Python) interpreter and
with a trace builder attached, whose basic blocks run in C in one step.
"""

import pytest

from miden_tpu.vm.assembler import assemble as j_assemble
from miden_tpu.vm.resume import execute_stepwise as j_execute_stepwise
from miden_tpu.vm.trace import TraceBuilder as JTraceBuilder
from miden_tpu_torch.vm.assembler import assemble
from miden_tpu_torch.vm.processor import ExecutionError, execute
from miden_tpu_torch.vm.resume import BreakReason, execute_stepwise
from miden_tpu_torch.vm.trace import TraceBuilder

LOOP_SRC = """
begin
    push.200 push.0
    dup.1 neq.0
    while.true
        add.1
        swap sub.1 swap
        dup.1 neq.0
    end
    swap drop
end
"""
#: LOOP_SRC ending at depth 16, as a trace builder requires
LOOP16_SRC = LOOP_SRC.replace("swap drop\nend", "swap drop swap drop\nend")
FIB_SRC = "begin push.0 push.1 repeat.300 swap dup.1 add end swap drop swap drop end"


def test_stepwise_matches_uninterrupted_execution():
    prog = assemble(LOOP_SRC)
    want = execute(prog, []).stack
    ctx = execute_stepwise(prog, [], cycles=64)
    pauses, clks = 0, []
    while not ctx.done:
        assert ctx.reason == BreakReason.CYCLE_BUDGET
        clks.append(ctx.clk)
        assert ctx.processor.clk >= 64 * (pauses + 1) - 1
        pauses += 1
        ctx.resume(64)
    assert ctx.reason == BreakReason.FINISHED
    assert pauses > 3 and clks == sorted(clks)
    assert list(ctx.output.stack) == list(want)


def test_stepwise_finish_and_single_shot():
    prog = assemble(LOOP_SRC)
    ctx = execute_stepwise(prog, [], cycles=32)
    assert ctx.reason == BreakReason.CYCLE_BUDGET
    assert list(ctx.finish().stack) == list(execute(prog, []).stack)
    assert execute_stepwise(prog, [], cycles=1 << 20).reason == BreakReason.FINISHED


def test_stepwise_cancel():
    ctx = execute_stepwise(assemble(LOOP_SRC), [], cycles=16)
    assert not ctx.done
    ctx.cancel()
    assert ctx.reason == BreakReason.CANCELLED
    with pytest.raises(ExecutionError):
        ctx.finish()


def test_stepwise_surfaces_execution_errors():
    ctx = execute_stepwise(assemble("begin push.1 push.0 u32div end"), [], cycles=1 << 16)
    assert ctx.reason == BreakReason.ERROR
    with pytest.raises(ExecutionError):
        ctx.finish()


def _pauses(ctx, step):
    seen = []
    while not ctx.done:
        seen.append((ctx.reason, ctx.clk, list(ctx.processor.stack)))
        ctx.resume(step)
    seen.append((ctx.reason, ctx.output.clk, list(ctx.output.stack)))
    return seen


@pytest.mark.parametrize("traced", [False, True], ids=["interpreter", "trace_builder"])
@pytest.mark.parametrize("src, first, step", [(LOOP16_SRC, 50, 37), (FIB_SRC, 100, 256), (LOOP16_SRC, 1, 1)],
                         ids=["loop", "fib", "loop_every_cycle"])
def test_pause_points_and_output_equal_miden_tpu(src, first, step, traced):
    mine = execute_stepwise(assemble(src), [3, 4], cycles=first, **({"tracer": TraceBuilder()} if traced else {}))
    theirs = j_execute_stepwise(
        j_assemble(src), [3, 4], cycles=first, **({"tracer": JTraceBuilder()} if traced else {})
    )
    got, want = _pauses(mine, step), _pauses(theirs, step)
    assert [(r, c, [int(v) for v in s]) for r, c, s in got] == [(r, c, [int(v) for v in s]) for r, c, s in want]
    assert got[-1][0] == BreakReason.FINISHED and (len(got) > 2 or traced)
