"""Host-side VM layer: operations, MAST, interpreter, assembler.

The VM layer is the trace-generating oracle of the port — it executes
Miden programs on the host and (via the execution tracer) feeds row
matrices to the device-side STARK prover. Behavioral spec:
the reference's core/src/{operations,mast} and processor/src.
"""

from .assembler import Assembler, AssemblyError, assemble
from .events import error_code_from_msg, event_id
from .mast import (
    BasicBlockNode,
    CallNode,
    DynNode,
    ExternalNode,
    JoinNode,
    LoopNode,
    MastForest,
    OpBatch,
    Program,
    SplitNode,
    batch_ops,
)
from .ops import BATCH_SIZE, GROUP_SIZE, OP_BITS, OPCODES, Op, push
from .processor import (
    AdviceProvider,
    ExecutionError,
    ExecutionOutput,
    Processor,
    StackInputs,
    execute,
)

__all__ = [
    "BATCH_SIZE",
    "GROUP_SIZE",
    "OP_BITS",
    "OPCODES",
    "AdviceProvider",
    "Assembler",
    "AssemblyError",
    "assemble",
    "error_code_from_msg",
    "event_id",
    "BasicBlockNode",
    "CallNode",
    "DynNode",
    "ExecutionError",
    "ExecutionOutput",
    "ExternalNode",
    "JoinNode",
    "LoopNode",
    "MastForest",
    "Op",
    "OpBatch",
    "Processor",
    "Program",
    "SplitNode",
    "StackInputs",
    "batch_ops",
    "execute",
    "push",
]
