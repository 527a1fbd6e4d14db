"""MAST interpreter: executes programs and produces execution outputs and
(via tracer hooks) the Miden execution trace.

Behavioral spec: processor/src/ — the FastProcessor interpreter loop
(fast/mod.rs:102, continuation-stack dispatch over MAST nodes), per-op
semantics under execution/operations/ (cited per handler), the do-while
Loop node (execution/loop.rs), and operation helper registers
(tracer.rs:338 OperationHelperRegisters).

Conventions:
  - operand stack: index 0 = top; logical depth (`depth`) never drops below
    16 (zeros shift in at the bottom once the overflow table is empty).
    `stack[16:]` is the overflow table contents, most recent first;
    `overflow_addrs` tracks the clk each overflow element was pushed at
    (trace_state.rs:157 StackState).
  - `call`/`syscall` start a new execution context: fresh memory context,
    operand stack truncated to 16 with the overflow saved for the return.
  - memory: element-addressable u32 addresses; word accesses must be
    4-aligned.
  - the hasher chiplet address allocator starts at 1 and advances 2 rows
    per permutation (execution_tracer.rs:1008 HasherChipletShim).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..field import gl
from ..hash import poseidon2_host as hp
from ..merkle import MerkleStore, NodeIndex
from .mast import (
    BasicBlockNode,
    CallNode,
    DynNode,
    ExternalNode,
    JoinNode,
    LoopNode,
    Program,
    SplitNode,
)
from .ops import OPCODES, Op

P = gl.P
U32_MAX = 0xFFFFFFFF
MIN_STACK_DEPTH = 16
# FRI fold-4 constants (fri_ops/mod.rs:186-194): τ = 2^48 generates the
# order-4 subgroup; τ⁻¹ and 2⁻¹ in Goldilocks
FRI_TAU_INV = 18446462594437873665
FRI_TWO_INV = 9223372034707292161
# ACE node ids are 30-bit (trace/chiplets/ace/instruction.rs:5-9)
ACE_MAX_ID = (1 << 30) - 1


class ExecutionError(Exception):
    pass


def _inv(v: int) -> int:
    return pow(v, P - 2, P) if v else 0


def _u16_limbs(v: int) -> tuple[int, int]:
    """(t0, t1): low/high 16-bit limbs of a u32."""
    return v & 0xFFFF, (v >> 16) & 0xFFFF


@dataclass
class AdviceProvider:
    """Nondeterministic inputs (processor/src/host/advice/mod.rs): a stack,
    a map of word→values, and a MerkleStore."""

    stack: list[int] = field(default_factory=list)  # index 0 popped first
    map: dict[tuple, list[int]] = field(default_factory=dict)
    store: MerkleStore = field(default_factory=MerkleStore)

    def pop_stack(self) -> int:
        if not self.stack:
            raise ExecutionError("advice stack is empty")
        return self.stack.pop(0)

    def pop_stack_word(self) -> list[int]:
        if len(self.stack) < 4:
            raise ExecutionError("advice stack underflow (word)")
        w = self.stack[:4]
        del self.stack[:4]
        return w


@dataclass
class StackInputs:
    """Initial operand stack; element 0 is the top (core/src/program/)."""

    values: list[int]

    def __post_init__(self):
        if len(self.values) > MIN_STACK_DEPTH:
            raise ExecutionError("too many stack inputs")
        self.values = [v % P for v in self.values]


@dataclass
class ExecutionOutput:
    stack: list[int]  # top first, padded to 16
    advice: AdviceProvider
    memory: dict
    clk: int
    deferred_root: tuple = (0, 0, 0, 0)  # final LOGDEFERRED fold
    # the deferred DAG witness (vm/deferred.py DeferredState), when every
    # LOGDEFERRED statement was host-registered (deferred_synced); None
    # for raw folds of unregistered digests
    deferred_state: object = None


class HasherAllocator:
    """Allocates hasher-chiplet controller addresses and records requests
    for later chiplet-trace building (execution_tracer.rs:1008). Addresses
    start at 1; each Poseidon2 permutation consumes 2 controller rows."""

    def __init__(self) -> None:
        self.addr = 1
        self.requests: list[tuple] = []  # (kind, addr, payload...)

    def _take(self, num_permutations: int) -> int:
        addr = self.addr
        self.addr += 2 * num_permutations
        return addr

    def hash_control_block(self, h1: list[int], h2: list[int], domain: int) -> int:
        addr = self._take(1)
        self.requests.append(("control_block", addr, list(h1), list(h2), domain))
        return addr

    def hash_basic_block(self, batches: list[list[int]]) -> int:
        addr = self._take(len(batches))
        self.requests.append(("basic_block", addr, [list(b) for b in batches]))
        return addr

    def permute(self, state: list[int]) -> int:
        addr = self._take(1)
        self.requests.append(("permute", addr, list(state)))
        return addr

    def build_merkle_root(self, value, path, index: int) -> int:
        siblings = list(path.nodes)
        addr = self._take(len(siblings))
        self.requests.append(("merkle_root", addr, tuple(value), siblings, index))
        return addr

    def update_merkle_root(self, old_value, new_value, path, index: int) -> int:
        siblings = list(path.nodes)
        addr = self._take(2 * len(siblings))
        self.requests.append(
            ("update_merkle_root", addr, tuple(old_value), tuple(new_value), siblings, index)
        )
        return addr


class NullTracer:
    """No-op tracer: plain execution."""

    def attach(self, proc):
        pass

    def on_join_start(self, node, addr):
        pass

    def on_split_start(self, node, addr):
        pass

    def on_loop_start(self, node, addr):
        pass

    def on_call_start(self, node, callee_hash, addr):
        pass

    def on_dyn_start(self, node, callee_hash, addr):
        pass

    def on_node_end(self, digest, is_loop_body, is_loop, is_call, is_syscall):
        pass

    def on_repeat(self, node):
        pass

    def on_span_start(self, node, addr):
        pass

    def on_respan(self, node, batch_index):
        pass

    def pre_op(self, op, op_idx_in_group):
        pass

    def post_op(self, op, helpers):
        pass

    def on_halt(self):
        pass


class Processor:
    """Iterative MAST executor with optional trace hooks."""

    def __init__(
        self,
        program: Program,
        stack_inputs: StackInputs | None = None,
        advice: AdviceProvider | None = None,
        max_cycles: int = 1 << 29,
        event_handlers: dict | None = None,
        tracer=None,
    ):
        self.program = program
        self.forest = program.forest
        inputs = (stack_inputs or StackInputs([])).values
        self.stack: list[int] = list(inputs) + [0] * (MIN_STACK_DEPTH - len(inputs))
        self.depth = MIN_STACK_DEPTH
        self.overflow_addrs: list[int] = []  # parallel to stack[16:], newest first
        self.advice = advice or AdviceProvider()
        self.memory: dict[tuple[int, int], list[int]] = {}  # (ctx, word_addr) -> word
        self.ctx = 0
        self.clk = 0
        self.max_cycles = max_cycles
        self.event_handlers = event_handlers or {}  # id → fn(processor)
        self.fn_hash = (0, 0, 0, 0)
        self.caller_hash = (0, 0, 0, 0)
        self._ctx_stack: list[tuple] = []
        self.hasher = HasherAllocator()
        self.tracer = tracer or NullTracer()
        self.range_checks: list[int] = []  # 16-bit values to range check
        # chiplet replay logs (execution_tracer.rs replay recording):
        # mem_log entries: (kind in {re,we,rw,ww}, ctx, addr, clk, values)
        self.mem_log: list[tuple] = []
        self.bitwise_log: list[tuple] = []  # (is_xor, a, b, result)
        self.kernel_log: list[tuple] = []  # accessed kernel proc digests
        # (ctx, ptr, clk, num_read_rows, num_eval_rows, var_words, instrs)
        self.ace_log: list[tuple] = []
        # deferred precompile claims: AND-chain root over statement digests
        # (core/src/deferred/node.rs Tag::AND; TRUE_DIGEST = zero root).
        # The full DAG witness lives in self.deferred (vm/deferred.py
        # DeferredState, core/src/deferred/state.rs): event handlers
        # register claim nodes, LOGDEFERRED advances the root through
        # log_verified_statement. Raw folds of digests the host never
        # registered keep executing (the constrained chain does not
        # require a witness) but clear deferred_synced, so no wire
        # witness is exported for partial proofs.
        from .deferred import DeferredState, default_registry

        self.deferred = DeferredState(default_registry())
        self.deferred_synced = True
        self.deferred_root: tuple = (0, 0, 0, 0)
        self.deferred_log: list[tuple] = []  # (statement_digest, new_root)
        # stepwise-execution suspension point (vm/resume.py; the analog
        # of fast/step.rs's per-step break check)
        self._step_hook = None
        self.tracer.attach(self)

    # -- stack helpers ------------------------------------------------------

    @property
    def overflow_addr(self) -> int:
        """b1: clk at which the last overflow element was pushed (0 = empty)."""
        return self.overflow_addrs[0] if self.overflow_addrs else 0

    def _push(self, v: int) -> None:
        self.stack.insert(0, v % P)
        self.depth += 1
        self.overflow_addrs.insert(0, self.clk)

    def _drop(self, n: int = 1) -> None:
        for _ in range(n):
            del self.stack[0]
            if self.depth > MIN_STACK_DEPTH:
                self.depth -= 1
                self.overflow_addrs.pop(0)
            else:
                self.stack.append(0)

    def _u32(self, idx: int) -> int:
        v = self.stack[idx]
        if v > U32_MAX:
            raise ExecutionError(f"stack[{idx}] = {v} is not a u32")
        return v

    def _range_check(self, *values: int) -> None:
        self.range_checks.extend(values)

    # -- execution ----------------------------------------------------------

    def execute(self) -> ExecutionOutput:
        self._execute_node(self.program.entrypoint)
        self.tracer.on_halt()
        return ExecutionOutput(
            stack=list(self.stack[:MIN_STACK_DEPTH]),
            advice=self.advice,
            memory=self.memory,
            clk=self.clk,
            deferred_root=tuple(self.deferred_root),
            deferred_state=self.deferred if self.deferred_synced else None,
        )

    def _tick(self, n: int = 1) -> None:
        self.clk += n
        if self.clk > self.max_cycles:
            raise ExecutionError("max cycles exceeded")
        if self._step_hook is not None:
            self._step_hook()

    def _node_digest(self, node_id: int) -> tuple:
        return self.forest[node_id].digest

    def _execute_node(self, node_id: int, is_loop_body: bool = False) -> None:
        node = self.forest[node_id]
        zero = (0, 0, 0, 0)
        if isinstance(node, BasicBlockNode):
            self._execute_basic_block(node, is_loop_body)
        elif isinstance(node, JoinNode):
            left = self.forest[node.children[0]].digest
            right = self.forest[node.children[1]].digest
            addr = self.hasher.hash_control_block(left, right, OPCODES["JOIN"])
            self.tracer.on_join_start(node, addr)
            self._tick()
            self._execute_node(node.children[0])
            self._execute_node(node.children[1])
            self._end_node(node.digest, is_loop_body)
        elif isinstance(node, SplitNode):
            on_true = self.forest[node.children[0]].digest
            on_false = self.forest[node.children[1]].digest
            addr = self.hasher.hash_control_block(on_true, on_false, OPCODES["SPLIT"])
            self.tracer.on_split_start(node, addr)
            cond = self.stack[0]
            self._drop()
            self._tick()
            if cond == 1:
                self._execute_node(node.children[0])
            elif cond == 0:
                self._execute_node(node.children[1])
            else:
                raise ExecutionError(f"split condition {cond} is not binary")
            self._end_node(node.digest, is_loop_body)
        elif isinstance(node, LoopNode):
            # do-while semantics (execution/loop.rs): the body is entered
            # unconditionally; the condition it leaves on top decides REPEAT
            # (pop 1, re-enter) or END (pop 0, exit)
            body = self.forest[node.children[0]].digest
            addr = self.hasher.hash_control_block(body, zero, OPCODES["LOOP"])
            self.tracer.on_loop_start(node, addr)
            self._tick()  # LOOP
            while True:
                self._execute_node(node.children[0], is_loop_body=True)
                cond = self.stack[0]
                if cond == 0:
                    self._end_node(node.digest, is_loop_body, is_loop=True, pops=1)
                    break
                if cond != 1:
                    raise ExecutionError(f"loop condition {cond} is not binary")
                self.tracer.on_repeat(node)
                self._drop()
                self._tick()  # REPEAT
        elif isinstance(node, CallNode):
            callee = self.forest[node.children[0]]
            domain = OPCODES["SYSCALL" if node.is_syscall else "CALL"]
            addr = self.hasher.hash_control_block(callee.digest, zero, domain)
            self.tracer.on_call_start(node, callee.digest, addr)
            if node.is_syscall:
                self.kernel_log.append(callee.digest)
            row_clk = self.clk
            self._tick()
            self._enter_call(node, callee, row_clk)
            self._execute_node(node.children[0])
            self._exit_call(node.digest, is_loop_body, node.is_syscall)
        elif isinstance(node, DynNode):
            # DYN/DYNCALL (execution/dyn.rs): read the callee hash from the
            # memory word at address s0, then shift the stack left by one
            addr_ptr = self.stack[0]
            if addr_ptr > U32_MAX or addr_ptr % 4:
                raise ExecutionError(f"dyn: invalid callee-hash address {addr_ptr}")
            digest = tuple(self.memory.get((self.ctx, addr_ptr), [0, 0, 0, 0]))
            domain = OPCODES["DYNCALL" if node.is_dyncall else "DYN"]
            addr = self.hasher.hash_control_block(zero, zero, domain)
            self.mem_log.append(("rw", self.ctx, addr_ptr, self.clk, list(digest)))
            self.tracer.on_dyn_start(node, digest, addr)
            self._drop()
            target = self.forest.find_root(digest)
            if target is None:
                target = self.forest._by_digest.get(digest)
            if target is None:
                raise ExecutionError(f"dynamic target {digest} not found")
            if node.is_dyncall:
                callee = self.forest[target]
                row_clk = self.clk
                self._tick()
                self._enter_call(node, callee, row_clk)
                self._execute_node(target)
                self._exit_call(node.digest, is_loop_body, is_syscall=False)
            else:
                self._tick()
                self._execute_node(target)
                self._end_node(node.digest, is_loop_body)
        elif isinstance(node, ExternalNode):
            target = self.forest._by_digest.get(node.digest)
            if target is None or target == node_id:
                raise ExecutionError(f"external node {node.digest} unresolved")
            self._execute_node(target, is_loop_body)
        else:
            raise ExecutionError(f"unknown node kind {type(node).__name__}")

    def _end_node(
        self,
        digest: tuple,
        is_loop_body: bool,
        is_loop: bool = False,
        is_call: bool = False,
        is_syscall: bool = False,
        pops: int = 0,
    ) -> None:
        self.tracer.on_node_end(digest, is_loop_body, is_loop, is_call, is_syscall)
        self._drop(pops)
        self._tick()  # END

    def _execute_basic_block(self, node: BasicBlockNode, is_loop_body: bool) -> None:
        addr = self.hasher.hash_basic_block([list(b.groups) for b in node.batches])
        # blocks inside the native op subset execute + trace in C
        # (~10^8 rows/s), including loop bodies (their END row carries
        # the h4 flag); anything else takes the exact Python path below
        from .native_trace import native_block_segment

        if native_block_segment(self, self.tracer, node, addr, is_loop_body):
            if self.clk > self.max_cycles:
                raise ExecutionError("max cycles exceeded")
            return
        self.tracer.on_span_start(node, addr)
        self._tick()  # SPAN
        for batch_index, batch in enumerate(node.batches):
            if batch_index > 0:
                self.tracer.on_respan(node, batch_index)
                self._tick()  # RESPAN
            for group_idx in range(batch.num_groups):
                start, end = batch.indptr[group_idx], batch.indptr[group_idx + 1]
                for op_idx_in_group, i in enumerate(range(start, end)):
                    op = batch.ops[i]
                    self.tracer.pre_op(op, op_idx_in_group)
                    helpers = self._execute_op(op)
                    self.tracer.post_op(op, helpers or [0] * 6)
                    self._tick()
        self._end_node(node.digest, is_loop_body)

    def _enter_call(self, node, callee, row_clk: int) -> None:
        self._ctx_stack.append(
            (
                self.ctx,
                self.stack[MIN_STACK_DEPTH:],
                self.overflow_addrs,
                self.depth,
                self.fn_hash,
                self.caller_hash,
            )
        )
        is_syscall = getattr(node, "is_syscall", False)
        if is_syscall:
            # Syscalls run in the root context; callee must be in the kernel.
            if self.program.kernel_digests and callee.digest not in self.program.kernel_digests:
                raise ExecutionError("syscall target not in kernel")
            self.caller_hash = self.fn_hash
            self.ctx = 0
        else:
            # New context id = clk of the row after the CALL (fast/mod.rs)
            self.ctx = self.clk
            self.fn_hash = callee.digest
            # initialize the frame pointer in the new context
            # (FMP_ADDR = u32::MAX−1 ← FMP_INIT = 2^31; core/src/lib.rs:118-121
            # and processor/src/execution/call.rs:74 — the code's address, not
            # the stale 2^32−1 in docs decoder/index.md §CALL)
            self.memory.setdefault((self.ctx, U32_MAX - 3), [0, 0, 0, 0])[2] = 1 << 31
            self.mem_log.append(("we", self.ctx, U32_MAX - 1, row_clk, [1 << 31]))
        self.stack = self.stack[:MIN_STACK_DEPTH]
        self.depth = MIN_STACK_DEPTH
        self.overflow_addrs = []

    def _exit_call(self, digest: tuple, is_loop_body: bool, is_syscall: bool) -> None:
        if self.depth != MIN_STACK_DEPTH:
            raise ExecutionError("call must return with depth 16")
        self.tracer.on_node_end(
            digest, is_loop_body, False, not is_syscall, is_syscall
        )
        (
            self.ctx,
            overflow,
            self.overflow_addrs,
            self.depth,
            self.fn_hash,
            self.caller_hash,
        ) = self._ctx_stack.pop()
        self.stack = self.stack[:MIN_STACK_DEPTH] + overflow
        self.depth = MIN_STACK_DEPTH + len(overflow)
        self._tick()  # END

    # -- system events (fast/basic_block/sys_event_handlers.rs) ---------

    def _handle_event(self, eid: int) -> None:
        """Run the handler for event id `eid`. During a handler the stack is
        [event_id, operands...] — the assembler emits push/emit/drop."""
        from .events import SYSTEM_EVENT_BY_ID

        # explicit host handlers take precedence, so a host can override a
        # built-in system event (mirrors the reference host's handler
        # registry shadowing)
        handler = self.event_handlers.get(eid)
        if handler is not None:
            handler(self)
            return
        name = SYSTEM_EVENT_BY_ID.get(eid)
        if name is None:
            raise ExecutionError(f"no handler for event id {eid}")
        s, adv = self.stack, self.advice
        if name == "sys::merkle_node_to_stack":
            depth, index, root = s[1], s[2], tuple(s[3:7])
            node = adv.store.get_node(root, NodeIndex(depth, index))
            adv.stack[0:0] = list(node)  # node[0] pops first
        elif name == "sys::merkle_node_merge":
            lhs, rhs = tuple(s[1:5]), tuple(s[5:9])
            parent = tuple(hp.merge(list(lhs), list(rhs)))
            adv.store.extend([(parent, lhs, rhs)])
        elif name in (
            "sys::map_value_to_stack",
            "sys::map_value_to_stack_n_0",
            "sys::map_value_to_stack_n_4",
            "sys::map_value_to_stack_n_8",
        ):
            key = tuple(s[1:5])
            values = adv.map.get(key)
            if values is None:
                raise ExecutionError(f"advice map key {key} not found")
            out = list(values)
            if name.endswith(("n_0", "n_4", "n_8")):
                pad_to = int(name[-1])
                if pad_to:
                    out += [0] * (-len(out) % pad_to)
                out.insert(0, len(values))
            adv.stack[0:0] = out
        elif name == "sys::map_value_count_to_stack":
            key = tuple(s[1:5])
            if key not in adv.map:
                raise ExecutionError(f"advice map key {key} not found")
            adv.stack.insert(0, len(adv.map[key]))
        elif name == "sys::has_map_key":
            adv.stack.insert(0, 1 if tuple(s[1:5]) in adv.map else 0)
        elif name == "sys::ext2_inv":
            # (a0 + a1·x) with x² = 7; inverse = (a0 − a1·x)/(a0² − 7·a1²)
            a0, a1 = s[1], s[2]
            d = (a0 * a0 - 7 * a1 * a1) % P
            if d == 0:
                raise ExecutionError("ext2inv: division by zero")
            dinv = pow(d, P - 2, P)
            # the HIGH coefficient pops first so two ADVPOPs leave the
            # inverse as [c0, c1] (c0 on top) for the EXT2MUL unit check
            # (assembler.py _ext2_inv; was reversed — ext2div/ext2inv
            # asserted on every call until the recursion masm used them)
            adv.stack[0:0] = [a1 and (P - a1) * dinv % P, a0 * dinv % P]
        elif name == "sys::ilog2":
            if s[1] == 0:
                raise ExecutionError("ilog2 of zero")
            adv.stack.insert(0, s[1].bit_length() - 1)
        elif name == "sys::u32_clz":
            adv.stack.insert(0, 32 - self._u32(1).bit_length())
        elif name == "sys::u32_ctz":
            v = self._u32(1)
            adv.stack.insert(0, (v & -v).bit_length() - 1 if v else 32)
        elif name == "sys::u32_clo":
            v = (~self._u32(1)) & U32_MAX
            adv.stack.insert(0, 32 - v.bit_length())
        elif name == "sys::u32_cto":
            v = (~self._u32(1)) & U32_MAX
            adv.stack.insert(0, (v & -v).bit_length() - 1 if v else 32)
        elif name == "sys::mem_to_map":
            # [event_id, KEY, start_addr, end_addr, ...] → map[KEY] = mem[start..end)
            key, start, end = tuple(s[1:5]), s[5], s[6]
            if start > U32_MAX or end > U32_MAX or start > end:
                raise ExecutionError("mem_to_map: invalid range")
            adv.map[key] = [self._mem_read_element(a) for a in range(start, end)]
        elif name in ("sys::hdword_to_map", "sys::hdword_to_map_with_domain"):
            # [event_id, A, B, ...]; key = hash(A || B, domain), values [A, B]
            a, b = list(s[1:5]), list(s[5:9])
            domain = s[9] if name.endswith("domain") else 0
            key = tuple(hp.merge_in_domain(a, b, domain))
            adv.map[key] = a + b
        elif name == "sys::hqword_to_map":
            words = [s[i] for i in range(1, 17)]
            key = tuple(hp.hash_elements_padded(words))
            adv.map[key] = words
        elif name == "sys::hperm_to_map":
            # state [RATE1, RATE2, CAP]; values = rate; key = permuted digest
            state = [s[i] for i in range(1, 13)]
            key = tuple(hp.permute(state)[0:4])
            adv.map[key] = state[:8]
        else:
            raise ExecutionError(f"system event {name} not implemented")

    # -- memory ---------------------------------------------------------

    def _mem_word(self, addr: int) -> list[int]:
        if addr > U32_MAX or addr % 4:
            raise ExecutionError(f"unaligned or invalid word address {addr}")
        return self.memory.setdefault((self.ctx, addr), [0, 0, 0, 0])

    def _mem_read_element(self, addr: int) -> int:
        if addr > U32_MAX:
            raise ExecutionError(f"invalid address {addr}")
        word = self.memory.get((self.ctx, addr - addr % 4))
        return word[addr % 4] if word else 0

    # -- ops ------------------------------------------------------------

    def _execute_op(self, op: Op) -> list[int] | None:  # noqa: C901
        """Executes one operation; returns the 6 user-op helper register
        values (tracer.rs:494 to_user_op_helpers) or None for ops without
        helpers."""
        s = self.stack
        name = op.name
        if name == "NOOP":
            return None
        # system (execution/operations/sys_ops)
        if name == "ASSERT":
            if s[0] != 1:
                raise ExecutionError(f"assertion failed (err={op.err_code})")
            self._drop()
        elif name == "SDEPTH":
            self._push(self.depth)
        elif name == "CLK":
            self._push(self.clk)
        elif name == "CALLER":
            s[0:4] = list(self.caller_hash)
        elif name == "EMIT":
            # Dispatch by the event id on top of the stack; system events
            # first, then user handlers (fast/basic_block/sys_event_handlers.rs:50).
            self._handle_event(s[0])
        # field ops (execution/operations/field_ops)
        elif name == "ADD":
            a, b = s[0], s[1]
            self._drop()
            s[0] = (a + b) % P
        elif name == "MUL":
            a, b = s[0], s[1]
            self._drop()
            s[0] = a * b % P
        elif name == "NEG":
            s[0] = (-s[0]) % P
        elif name == "INV":
            if s[0] == 0:
                raise ExecutionError("division by zero")
            s[0] = pow(s[0], P - 2, P)
        elif name == "INCR":
            s[0] = (s[0] + 1) % P
        elif name == "NOT":
            if s[0] > 1:
                raise ExecutionError("not: operand not binary")
            s[0] ^= 1
        elif name == "AND":
            a, b = s[0], s[1]
            if a > 1 or b > 1:
                raise ExecutionError("and: operand not binary")
            self._drop()
            s[0] = a & b
        elif name == "OR":
            a, b = s[0], s[1]
            if a > 1 or b > 1:
                raise ExecutionError("or: operand not binary")
            self._drop()
            s[0] = a | b
        elif name == "EQ":
            a, b = s[0], s[1]
            self._drop()
            s[0] = 1 if a == b else 0
            return [_inv((a - b) % P), 0, 0, 0, 0, 0]
        elif name == "EQZ":
            top = s[0]
            s[0] = 1 if top == 0 else 0
            return [_inv(top), 0, 0, 0, 0, 0]
        elif name == "EXPACC":
            # [lsb', base², acc·base^lsb, exp>>1] (field_ops/mod.rs:195)
            base, acc, exp = s[1], s[2], s[3]
            lsb = exp & 1
            acc_update = base if lsb else 1
            s[0] = lsb
            s[1] = base * base % P
            s[2] = acc * acc_update % P
            s[3] = exp >> 1
            return [acc_update, 0, 0, 0, 0, 0]
        elif name == "EXT2MUL":
            # (x²−7)-extension product into positions 2,3 (field_ops:227)
            b0, b1, a0, a1 = s[0], s[1], s[2], s[3]
            s[2] = (a0 * b0 + 7 * a1 * b1) % P
            s[3] = (a0 * b1 + a1 * b0) % P
        # u32 ops (execution/operations/u32_ops)
        elif name == "U32SPLIT":
            # [value] → [lo, hi], lo on top (u32_ops/mod.rs:51)
            v = s[0]
            lo, hi = v & U32_MAX, v >> 32
            s[0] = hi
            self._push(lo)
            t0, t1 = _u16_limbs(lo)
            t2, t3 = _u16_limbs(hi)
            self._range_check(t0, t1, t2, t3)
            return [t0, t1, t2, t3, _inv((U32_MAX - hi) % P), 0]
        elif name == "U32ADD":
            a, b = self._u32(0), self._u32(1)
            r = a + b
            lo, carry = r & U32_MAX, r >> 32
            s[0], s[1] = lo, carry
            t0, t1 = _u16_limbs(lo)
            t2, t3 = _u16_limbs(carry)
            self._range_check(t0, t1, t2, t3)
            return [t0, t1, t2, t3, 0, 0]
        elif name == "U32ADD3":
            a, b, c = self._u32(0), self._u32(1), self._u32(2)
            r = a + b + c
            self._drop()
            lo, carry = r & U32_MAX, r >> 32
            s[0], s[1] = lo, carry
            t0, t1 = _u16_limbs(lo)
            t2, t3 = _u16_limbs(carry)
            self._range_check(t0, t1, t2, t3)
            return [t0, t1, t2, t3, 0, 0]
        elif name == "U32SUB":
            b, a = self._u32(0), self._u32(1)
            diff = (a - b) & U32_MAX
            borrow = 1 if a < b else 0
            s[0], s[1] = borrow, diff
            t0, t1 = _u16_limbs(diff)
            self._range_check(t0, t1)
            return [t0, t1, 0, 0, 0, 0]
        elif name == "U32MUL":
            a, b = self._u32(0), self._u32(1)
            r = a * b
            lo, hi = r & U32_MAX, r >> 32
            s[0], s[1] = lo, hi
            t0, t1 = _u16_limbs(lo)
            t2, t3 = _u16_limbs(hi)
            self._range_check(t0, t1, t2, t3)
            return [t0, t1, t2, t3, _inv((U32_MAX - hi) % P), 0]
        elif name == "U32MADD":
            a, b, c = self._u32(0), self._u32(1), self._u32(2)
            r = a * b + c
            self._drop()
            lo, hi = r & U32_MAX, r >> 32
            s[0], s[1] = lo, hi
            t0, t1 = _u16_limbs(lo)
            t2, t3 = _u16_limbs(hi)
            self._range_check(t0, t1, t2, t3)
            return [t0, t1, t2, t3, _inv((U32_MAX - hi) % P), 0]
        elif name == "U32DIV":
            b, a = self._u32(0), self._u32(1)
            if b == 0:
                raise ExecutionError("division by zero")
            q, r = a // b, a % b
            s[0], s[1] = r, q
            # lo = numerator − quotient; hi = denominator − remainder − 1
            lo, hi = a - q, b - r - 1
            t0, t1 = _u16_limbs(lo)
            t2, t3 = _u16_limbs(hi)
            self._range_check(t0, t1, t2, t3)
            return [t0, t1, t2, t3, 0, 0]
        elif name == "U32AND":
            a, b = self._u32(0), self._u32(1)
            self._drop()
            s[0] = a & b
            self.bitwise_log.append((0, a, b, a & b))
        elif name == "U32XOR":
            a, b = self._u32(0), self._u32(1)
            self._drop()
            s[0] = a ^ b
            self.bitwise_log.append((1, a, b, a ^ b))
        elif name == "U32ASSERT2":
            first, second = self._u32(0), self._u32(1)
            t0, t1 = _u16_limbs(second)
            t2, t3 = _u16_limbs(first)
            self._range_check(t0, t1, t2, t3)
            return [t0, t1, t2, t3, 0, 0]
        # stack ops (execution/operations/stack_ops)
        elif name == "PAD":
            self._push(0)
        elif name == "DROP":
            self._drop()
        elif name == "SWAP":
            s[0], s[1] = s[1], s[0]
        elif name.startswith("SWAPW") or name == "SWAPDW":
            if name == "SWAPDW":
                s[0:8], s[8:16] = s[8:16], s[0:8]
            else:
                off = {"SWAPW": 4, "SWAPW2": 8, "SWAPW3": 12}[name]
                s[0:4], s[off : off + 4] = s[off : off + 4], s[0:4]
        elif name.startswith("DUP"):
            self._push(s[int(name[3:])])
        elif name.startswith("MOVUP"):
            n = int(name[5:])
            s.insert(0, s.pop(n))
        elif name.startswith("MOVDN"):
            n = int(name[5:])
            s.insert(n, s.pop(0))
        elif name == "CSWAP":
            c = s[0]
            if c > 1:
                raise ExecutionError("cswap: condition not binary")
            self._drop()
            if c:
                s[0], s[1] = s[1], s[0]
        elif name == "CSWAPW":
            c = s[0]
            if c > 1:
                raise ExecutionError("cswapw: condition not binary")
            self._drop()
            if c:
                s[0:4], s[4:8] = s[4:8], s[0:4]
        elif name == "PUSH":
            self._push(op.imm)
        # io ops (execution/operations/io_ops)
        elif name == "ADVPOP":
            self._push(self.advice.pop_stack())
        elif name == "ADVPOPW":
            s[0:4] = [v % P for v in self.advice.pop_stack_word()]
        elif name == "MLOAD":
            addr = s[0]
            s[0] = self._mem_read_element(addr)
            self.mem_log.append(("re", self.ctx, addr, self.clk, [s[0]]))
        elif name == "MLOADW":
            addr = s[0]
            self._drop()
            s[0:4] = list(self._mem_word(addr))
            self.mem_log.append(("rw", self.ctx, addr, self.clk, s[0:4]))
        elif name == "MSTORE":
            addr = s[0]
            self._drop()
            if addr > U32_MAX:
                raise ExecutionError(f"invalid address {addr}")
            word = self.memory.setdefault((self.ctx, addr - addr % 4), [0, 0, 0, 0])
            word[addr % 4] = s[0]
            self.mem_log.append(("we", self.ctx, addr, self.clk, [s[0]]))
        elif name == "MSTOREW":
            addr = s[0]
            self._drop()
            self._mem_word(addr)[:] = s[0:4]
            self.mem_log.append(("ww", self.ctx, addr, self.clk, s[0:4]))
        elif name == "MSTREAM":
            # Two words from mem[s[12]]; the word at addr goes to the top,
            # s[12] += 8 (io_ops/mod.rs:226-252).
            addr = s[12]
            s[0:4] = list(self._mem_word(addr))
            s[4:8] = list(self._mem_word(addr + 4))
            s[12] = (addr + 8) % P
            self.mem_log.append(("rw", self.ctx, addr, self.clk, s[0:4]))
            self.mem_log.append(("rw", self.ctx, addr + 4, self.clk, s[4:8]))
        elif name == "PIPE":
            # Two advice words → memory and stack; first popped word on top
            # (io_ops/mod.rs:276-305).
            addr = s[12]
            w0 = [v % P for v in self.advice.pop_stack_word()]
            w1 = [v % P for v in self.advice.pop_stack_word()]
            self._mem_word(addr)[:] = w0
            self._mem_word(addr + 4)[:] = w1
            s[0:4] = w0
            s[4:8] = w1
            s[12] = (addr + 8) % P
            self.mem_log.append(("ww", self.ctx, addr, self.clk, w0))
            self.mem_log.append(("ww", self.ctx, addr + 4, self.clk, w1))
        # crypto ops (execution/operations/crypto_ops)
        elif name == "HPERM":
            state = [s[i] for i in range(12)]
            addr = self.hasher.permute(state)
            out = hp.permute(state)
            s[0:12] = out
            return [addr, 0, 0, 0, 0, 0]
        elif name == "MPVERIFY":
            # [V, depth, index, R, ...]: verify that the tree with root R
            # opens to V at (depth, index); stack unchanged
            # (execution/operations/crypto_ops/mod.rs:96-105)
            node_claim = s[0:4]
            depth, index = s[4], s[5]
            root = tuple(s[6:10])
            node = self.advice.store.get_node(root, NodeIndex(depth, index))
            if list(node) != node_claim:
                raise ExecutionError(f"merkle path verification failed (err={op.err_code})")
            _, path = self.advice.store.get_path(root, NodeIndex(depth, index))
            addr = self.hasher.build_merkle_root(node, path, index)
            return [addr, 0, 0, 0, 0, 0]
        elif name == "MRUPDATE":
            # [V_old, depth, index, R_old, V_new, ...] → [R_new, depth,
            # index, R_old, V_new, ...] (crypto_ops/mod.rs:161-170)
            old = s[0:4]
            depth, index = s[4], s[5]
            old_root = tuple(s[6:10])
            new_val = tuple(s[10:14])
            cur = self.advice.store.get_node(old_root, NodeIndex(depth, index))
            if list(cur) != old:
                raise ExecutionError("merkle update: old value mismatch")
            _, path = self.advice.store.get_path(old_root, NodeIndex(depth, index))
            new_root = self.advice.store.set_node(
                old_root, NodeIndex(depth, index), new_val
            )
            addr = self.hasher.update_merkle_root(old, new_val, path, index)
            s[0:4] = list(new_root)
            return [addr, 0, 0, 0, 0, 0]
        elif name == "HORNERBASE":
            # 8 Horner steps with base-field coefficients c0..c7 = s[0..8]
            # (c0 = highest degree); α read element-wise from mem[s[13]],
            # acc at s[14:16]; helpers [α0, α1, tmp1, tmp0]
            # (crypto_ops/mod.rs:273-337, docs crypto_ops.md §HORNERBASE)
            addr = s[13]
            a0 = self._mem_read_element(addr)
            a1 = self._mem_read_element(addr + 1)
            self.mem_log.append(("re", self.ctx, addr, self.clk, [a0]))
            self.mem_log.append(("re", self.ctx, addr + 1, self.clk, [a1]))
            alpha = (a0, a1)

            def step(acc, c):
                return gl.ext_add(gl.ext_mul(acc, alpha), (c % P, 0))

            acc = (s[14], s[15])
            tmp0 = step(step(acc, s[0]), s[1])
            tmp1 = step(step(step(tmp0, s[2]), s[3]), s[4])
            acc_new = step(step(step(tmp1, s[5]), s[6]), s[7])
            s[14], s[15] = acc_new
            return [a0, a1, tmp1[0], tmp1[1], tmp0[0], tmp0[1]]
        elif name == "HORNEREXT":
            # 4 Horner steps with extension coefficients c_i = (s[2i],
            # s[2i+1]) (c0 = highest degree); α from the word at mem[s[13]]
            # = [α0, α1, k0, k1]; helpers [α0, α1, k0, k1, tmp]
            # (crypto_ops/mod.rs:383-446, docs crypto_ops.md §HORNEREXT)
            addr = s[13]
            word = list(self._mem_word(addr))
            self.mem_log.append(("rw", self.ctx, addr, self.clk, word))
            alpha = (word[0], word[1])

            def stepe(acc, c):
                return gl.ext_add(gl.ext_mul(acc, alpha), c)

            acc = (s[14], s[15])
            tmp = stepe(stepe(acc, (s[0], s[1])), (s[2], s[3]))
            acc_new = stepe(stepe(tmp, (s[4], s[5])), (s[6], s[7]))
            s[14], s[15] = acc_new
            return [word[0], word[1], word[2], word[3], tmp[0], tmp[1]]
        elif name == "FRIE2F4":
            # One factor-4 FRI fold over QuadFelt with cross-layer
            # consistency (fri_ops/mod.rs:47-140): leaf values in
            # bit-reversed order [q0, q2, q1, q3] on s[0:8], then
            # folded_pos, coset, poe, pe(2), alpha(2), layer_ptr
            q_bitrev = [(s[0], s[1]), (s[2], s[3]), (s[4], s[5]), (s[6], s[7])]
            folded_pos, coset, poe = s[8], s[9], s[10]
            pe = (s[11], s[12])
            alpha = (s[13], s[14])
            layer_ptr = s[15]
            if coset > 3:
                raise ExecutionError(f"coset index {coset} exceeds 3")
            if poe == 0:
                raise ExecutionError("FRI domain size was 0")
            q = [q_bitrev[0], q_bitrev[2], q_bitrev[1], q_bitrev[3]]
            if q[coset] != pe:
                raise ExecutionError(
                    "degree-respecting projection is inconsistent"
                )
            x = poe * pow(FRI_TAU_INV, coset, P) % P
            x_inv = gl.inv(x)
            ev = gl.ext_mul_base(alpha, x_inv)
            es = gl.ext_mul(ev, ev)

            def fold2(a, b, ep):
                su = gl.ext_add(a, b)
                df = gl.ext_sub(a, b)
                return gl.ext_mul_base(
                    gl.ext_add(su, gl.ext_mul(df, ep)), FRI_TWO_INV
                )

            tmp0 = fold2(q[0], q[2], ev)
            tmp1 = fold2(q[1], q[3], gl.ext_mul_base(ev, FRI_TAU_INV))
            folded = fold2(tmp0, tmp1, es)
            poe2 = poe * poe % P
            nptr = (layer_ptr + 8) % P
            self._drop()
            s[0:2] = tmp0
            s[2:4] = tmp1
            s[4:7] = [1 if coset == i else 0 for i in (1, 2, 3)]
            s[7] = poe2
            s[8] = s[9] = nptr
            s[10] = poe2 * poe2 % P
            s[11] = folded_pos
            s[12:14] = folded
            s[14] = nptr
            return [ev[0], ev[1], es[0], es[1], x, x_inv]
        elif name == "CRYPTOSTREAM":
            # AEAD keystream step: two plaintext words at mem[s12] plus the
            # top-8 sponge rate → ciphertext words at mem[s13] and s[0:8];
            # both pointers advance by 8 (crypto_ops/mod.rs:506-560)
            src, dst = s[12], s[13]
            if src < dst + 8 and dst < src + 8:
                raise ExecutionError(
                    f"crypto_stream src/dst ranges overlap ({src}, {dst})"
                )
            p1 = list(self._mem_word(src))
            p2 = list(self._mem_word(src + 4))
            self.mem_log.append(("rw", self.ctx, src, self.clk, p1))
            self.mem_log.append(("rw", self.ctx, src + 4, self.clk, p2))
            c1 = [(p1[i] + s[i]) % P for i in range(4)]
            c2 = [(p2[i] + s[4 + i]) % P for i in range(4)]
            self._mem_word(dst)[:] = c1
            self._mem_word(dst + 4)[:] = c2
            self.mem_log.append(("ww", self.ctx, dst, self.clk, c1))
            self.mem_log.append(("ww", self.ctx, dst + 4, self.clk, c2))
            s[0:4] = c1
            s[4:8] = c2
            s[12] = (src + 8) % P
            s[13] = (dst + 8) % P
        elif name == "EVALCIRCUIT":
            # [ptr, num_read, num_eval, ...]: evaluate the arithmetic
            # circuit at mem[ptr] via the ACE chiplet and assert the
            # result is zero; stack unchanged
            # (execution/operations/eval_circuit.rs:31-110)
            ptr, num_vars, num_eval = s[0], s[1], s[2]
            if num_vars == 0 or num_vars % 2:
                raise ExecutionError(
                    f"ACE variable count must be even and non-zero: {num_vars}"
                )
            if num_eval == 0 or num_eval % 4:
                raise ExecutionError(
                    f"ACE gate count must be word-aligned and non-zero: {num_eval}"
                )
            total = num_vars + num_eval
            if total > ACE_MAX_ID:
                raise ExecutionError(f"ACE wire count {total} exceeds 2^30-1")
            values: dict[int, tuple[int, int]] = {}
            nid = total - 1
            p = ptr
            var_words, instrs = [], []
            for _ in range(num_vars // 2):
                w = list(self._mem_word(p))
                self.mem_log.append(("rw", self.ctx, p, self.clk, w))
                var_words.append(w)
                values[nid] = (w[0], w[1])
                values[nid - 1] = (w[2], w[3])
                nid -= 2
                p += 4
            for _ in range(num_eval):
                ins = self._mem_read_element(p)
                self.mem_log.append(("re", self.ctx, p, self.clk, [ins]))
                instrs.append(ins)
                id_l = ins & ACE_MAX_ID
                id_r = (ins >> 30) & ACE_MAX_ID
                opv = ins >> 60
                if opv > 2 or id_l <= nid or id_r <= nid or max(id_l, id_r) >= total:
                    raise ExecutionError(f"invalid ACE instruction {ins}")
                vl, vr = values[id_l], values[id_r]
                if opv == 0:
                    v = gl.ext_sub(vl, vr)
                elif opv == 1:
                    v = gl.ext_mul(vl, vr)
                else:
                    v = gl.ext_add(vl, vr)
                values[nid] = v
                nid -= 1
                p += 1
            if values[0] != (0, 0):
                raise ExecutionError("ACE circuit does not evaluate to zero")
            self.ace_log.append(
                (self.ctx, ptr, self.clk, num_vars // 2, num_eval,
                 var_words, instrs)
            )
        elif name == "LOGDEFERRED":
            # fold the statement digest at s[4:8] into the rolling deferred
            # root: root' = Poseidon2([root, stmt, Tag::AND])[rate0]; the
            # full output state lands on s[0:12] like HPERM
            # (crypto_ops/mod.rs:459-500)
            stmt = [s[4], s[5], s[6], s[7]]
            prev = list(self.deferred_root)
            state = [*prev, *stmt, 1, 0, 0, 0]
            addr = self.hasher.permute(state)
            out = hp.permute(state)
            self.deferred_root = tuple(out[0:4])
            self.deferred_log.append((tuple(stmt), self.deferred_root))
            if self.deferred_synced:
                from .deferred import DeferredError

                try:
                    self.deferred.log_verified_statement(
                        tuple(stmt), self.deferred_root
                    )
                except DeferredError:
                    # raw fold of an unregistered statement: the in-
                    # circuit chain still advances, but the DAG witness
                    # can no longer justify the root
                    self.deferred_synced = False
            s[0:12] = out
            return [addr, *prev, 0]
        else:
            raise ExecutionError(f"operation {name} not implemented yet")
        return None


def execute(
    program: Program,
    stack_inputs: list[int] | StackInputs | None = None,
    advice: AdviceProvider | None = None,
    **opts,
) -> ExecutionOutput:
    """Execute a program (processor/src/lib.rs:114 `execute`)."""
    if isinstance(stack_inputs, list):
        stack_inputs = StackInputs(stack_inputs)
    return Processor(program, stack_inputs, advice, **opts).execute()
