"""The Fibonacci loop of the reference's masm examples (the real-program row
of ``bench.py``), fed from the stack: with ``x, y`` on top, each of the
``repeat`` iterations of ``swap dup.1 add`` turns ``(x, y)`` into
``(x + y, x)``; ``swap drop swap drop`` then keeps the sum on top.

The port's assembler puts the frame-pointer prologue
(``push.2^31 push.2^32-2 mstore drop``, crates/assembly/src/fmp.rs:12-18)
in a block of its own and joins it with the body, so the program's digest
is ``join(prologue, body)``.
"""

from __future__ import annotations

from .. import gl
from ..vm.mast import block_digest, join_digest
from ..vm.ops import Op

FMP_ADDR = (1 << 32) - 2
FMP_INIT = 1 << 31


def masm(program: dict) -> str:
    """The program's source, as the port's assembler takes it."""
    return f"begin repeat.{int(program['repeat'])} swap dup.1 add end swap drop swap drop end"


def program_hash(program: dict) -> tuple:
    """The program's MAST digest."""
    prologue = [Op("PUSH", FMP_INIT), Op("PUSH", FMP_ADDR), Op("MSTORE"), Op("DROP")]
    body = [Op("SWAP"), Op("DUP1"), Op("ADD")] * int(program["repeat"])
    body += [Op("SWAP"), Op("DROP"), Op("SWAP"), Op("DROP")]
    return join_digest(block_digest(prologue), block_digest(body))


def stack_outputs(program: dict, stack_inputs: list) -> list:
    """The 16 stack values the program leaves, top first, for 16 stack
    inputs, top first: every drop shifts the stack up and a zero in at the
    bottom."""
    x, y, *rest = (v % gl.P for v in stack_inputs)
    for _ in range(int(program["repeat"])):
        x, y = gl.add(x, y), x
    return [x, *rest[1:], 0, 0]
