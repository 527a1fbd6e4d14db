"""MASM assembler: Miden Assembly source → MAST programs.

Behavioral spec: crates/assembly/ — the instruction→operation lowering
tables under crates/assembly/src/instruction/{mod,field_ops,u32_ops,
ext2_ops,env_ops,mem_ops,crypto_ops}.rs (each lowering below cites its
source), the binary-tree body joining of
crates/assembly/src/mast_forest_builder.rs:790, and system-event lowering
`push.<id> emit drop` (basic_block_builder.rs:139).

Supported surface (grows with the stdlib milestone): `use` imports,
`const` definitions (int / hex / event("…")), `proc` / `pub proc` /
legacy `proc.name` & `export.name` definitions, `begin…end` entrypoints,
`if.true/else/end`, `while.true/end`, compile-time `repeat.N/end`,
`exec/call/syscall/procref`, and the instruction set lowered below.
Procedure locals are not yet supported.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..field import gl
from .events import SYSTEM_EVENT_IDS, error_code_from_msg, event_id
from .mast import MastForest, Program
from .ops import Op

P = gl.P


class AssemblyError(Exception):
    pass


# ---------------------------------------------------------------------------
# Lowering helpers (each mirrors a helper in crates/assembly/src/instruction/)
# ---------------------------------------------------------------------------


def _ops(*names: str) -> list[Op]:
    return [Op(n) for n in names]


def _push_felt(v: int) -> list[Op]:
    """push_value_ops (crates/assembly/src/lib.rs:75)."""
    v %= P
    if v == 0:
        return _ops("PAD")
    if v == 1:
        return _ops("PAD", "INCR")
    return [Op("PUSH", v)]


def _sys_event(name: str) -> list[Op]:
    """push_system_event (basic_block_builder.rs:139-142)."""
    return [Op("PUSH", SYSTEM_EVENT_IDS[name]), Op("EMIT"), Op("DROP")]


# Frame-pointer memory cell (core/src/lib.rs:118-121). NB the code is
# authoritative: FMP_ADDR = u32::MAX - 1, not the 2^32-1 the docs claim.
FMP_ADDR = (1 << 32) - 2
FMP_INIT = 1 << 31


def _fmp_init() -> list[Op]:
    """fmp_initialization_sequence (crates/assembly/src/fmp.rs:12-18).

    Emitted as the prologue of every program entrypoint
    (crates/assembly/src/assembler.rs:1341-1349)."""
    return [Op("PUSH", FMP_INIT), Op("PUSH", FMP_ADDR), Op("MSTORE"), Op("DROP")]


def _fmp_frame(num_locals: int, start: bool) -> list[Op]:
    """fmp_{start,end}_frame_sequence (crates/assembly/src/fmp.rs:26-50):
    bump the frame pointer by the word-aligned local count on entry, undo it
    on exit."""
    aligned = -(-num_locals // 4) * 4
    delta = aligned % P if start else (-aligned) % P
    return [
        Op("PUSH", delta),
        Op("PUSH", FMP_ADDR),
        Op("MLOAD"),
        Op("ADD"),
        Op("PUSH", FMP_ADDR),
        Op("MSTORE"),
        Op("DROP"),
    ]


def _local_addr(index: int, num_locals: int, is_single: bool) -> list[Op]:
    """local_to_absolute_addr (crates/assembly/src/instruction/mem_ops.rs:131):
    push ``fmp - (aligned_num_locals - index)`` — locals live under the frame
    pointer."""
    if num_locals == 0:
        raise AssemblyError(
            "procedure local referenced but procedure declares no locals"
        )
    max_idx = num_locals - 1 if is_single else num_locals - 4
    if index > max_idx or max_idx < 0:
        raise AssemblyError(
            f"local index {index} out of range for {num_locals} locals"
        )
    aligned = -(-num_locals // 4) * 4
    offset = (index - aligned) % P
    return _push_felt(offset) + [Op("PUSH", FMP_ADDR), Op("MLOAD"), Op("ADD")]


def _reversew() -> list[Op]:
    # push_reversew (instruction/mod.rs:645)
    return _ops("MOVDN3", "SWAP", "MOVUP2")


def _assert(err: int = 0) -> Op:
    return Op("ASSERT", err_code=err)


# field_ops.rs comparison helpers ------------------------------------------


def _split_elements() -> list[Op]:
    return _ops("SWAP", "U32SPLIT", "MOVUP2", "U32SPLIT")


def _check_lt_high_bits() -> list[Op]:
    return _ops("MOVUP3", "MOVUP2", "U32SUB", "SWAP", "EQZ", "MOVUP2", "MOVUP3", "SWAP")


def _check_gt_high_bits() -> list[Op]:
    return _ops("SWAP", "MOVUP3", "U32SUB", "SWAP", "EQZ", "MOVUP2", "MOVUP3")


def _check_lt() -> list[Op]:
    return _ops("U32SUB", "SWAP", "DROP")


def _check_lte() -> list[Op]:
    return _ops("U32SUB", "SWAP", "EQZ", "OR")


def _lt() -> list[Op]:
    # field_ops::lt (17 cycles)
    return _split_elements() + _check_lt_high_bits() + _check_lt() + _ops("AND", "OR")


def _lte() -> list[Op]:
    return _split_elements() + _check_lt_high_bits() + _check_lte() + _ops("AND", "OR")


def _gt() -> list[Op]:
    return _split_elements() + _check_gt_high_bits() + _check_lt() + _ops("AND", "OR")


def _gte() -> list[Op]:
    return _split_elements() + _check_gt_high_bits() + _check_lte() + _ops("AND", "OR")


def _pow2() -> list[Op]:
    # append_pow2_op (field_ops.rs:128): 2^exp for exp on top
    return (
        [Op("PUSH", 2)]
        + _ops("PAD", "INCR", "SWAP", "PAD")
        + _ops(*["EXPACC"] * 6)
        + _ops("DROP", "DROP", "SWAP", "EQZ")
        + [_assert()]
    )


def _exp_bits(bits: int) -> list[Op]:
    # field_ops::exp (9 + bits cycles)
    if bits > 64:
        raise AssemblyError("exp: bit length out of range")
    return (
        _ops("PAD", "INCR", "MOVUP2", "PAD")
        + _ops(*["EXPACC"] * bits)
        + _ops("DROP", "DROP", "SWAP", "EQZ")
        + [_assert()]
    )


def _exp_imm(pow_: int) -> list[Op]:
    # field_ops::exp_imm / perform_exp_for_small_power
    if pow_ <= 7:
        if pow_ == 0:
            return _ops("DROP", "PAD", "INCR")
        if pow_ == 1:
            return _ops("NOOP")
        return _ops(*["DUP0"] * (pow_ - 1), *["MUL"] * (pow_ - 1))
    bits = pow_.bit_length()
    return [Op("PUSH", pow_)] + _exp_bits(bits)


def _assertw(err: int = 0) -> list[Op]:
    # field_ops::assertw (11 cycles)
    out: list[Op] = []
    for mov in ("MOVUP4", "MOVUP3", "MOVUP2"):
        out += [Op(mov), Op("EQ"), _assert(err)]
    out += [Op("EQ"), _assert(err)]
    return out


def _eqw() -> list[Op]:
    return _ops(
        "DUP7", "DUP4", "EQ",
        "DUP7", "DUP4", "EQ", "AND",
        "DUP6", "DUP3", "EQ", "AND",
        "DUP5", "DUP2", "EQ", "AND",
    )


# u32_ops.rs helpers --------------------------------------------------------


def _push_u32(v: int) -> list[Op]:
    if v >= 1 << 32:
        raise AssemblyError(f"immediate {v} is not a u32")
    return _push_felt(v)


def _u32_arith(op: str, mode: str, imm: int | None) -> list[Op]:
    """handle_arithmetic_operation (u32_ops.rs): mode ∈ wrapping /
    overflowing / widening."""
    out = _push_u32(imm) if imm is not None else []
    out.append(Op(op))
    if op in ("U32ADD", "U32MUL"):
        # output [lo, hi]: overflowing wants [hi-on-... ] reordered
        if mode == "overflowing":
            out.append(Op("SWAP"))
        elif mode == "wrapping":
            out += _ops("SWAP", "DROP")
    elif op == "U32SUB" and mode == "wrapping":
        out.append(Op("DROP"))
    return out


def _u32_division(kind: str, imm: int | None) -> list[Op]:
    out: list[Op] = []
    if imm is not None:
        if imm == 0:
            raise AssemblyError("division by zero")
        out += _push_u32(imm)
    out.append(Op("U32DIV"))
    if kind == "div":
        out.append(Op("DROP"))
    elif kind == "mod":
        out += _ops("SWAP", "DROP")
    return out


def _prepare_bitwise(imm: int | None, max_value: int = 31) -> list[Op]:
    if imm is None:
        return _pow2()
    if imm == 0:
        return _ops("NOOP")
    if imm > max_value:
        raise AssemblyError(f"shift amount {imm} out of range")
    return [Op("PUSH", 1 << imm)]


def _u32popcnt() -> list[Op]:
    return (
        _ops("DUP0")
        + [Op("PUSH", 1 << 1)] + _ops("U32DIV", "DROP")
        + [Op("PUSH", 0x55555555)] + _ops("U32AND", "U32SUB", "DROP", "DUP0")
        + [Op("PUSH", 1 << 2)] + _ops("U32DIV", "DROP")
        + [Op("PUSH", 0x33333333)] + _ops("U32AND", "SWAP")
        + [Op("PUSH", 0x33333333)] + _ops("U32AND", "U32ADD", "SWAP", "DROP", "DUP0")
        + [Op("PUSH", 1 << 4)] + _ops("U32DIV", "DROP", "U32ADD", "SWAP", "DROP")
        + [Op("PUSH", 0x0F0F0F0F)] + _ops("U32AND")
        + [Op("PUSH", 0x01010101)] + _ops("U32MUL", "SWAP", "DROP")
        + [Op("PUSH", 1 << 24)] + _ops("U32DIV", "DROP")
    )


# crypto_ops.rs helpers -----------------------------------------------------


def _hash_1to1() -> list[Op]:
    return (
        _ops("PAD", "PAD", "PAD", "PAD", "PAD", "PAD", "PAD")
        + [Op("PUSH", 4)]
        + _ops("SWAPW2", "HPERM", "SWAPW2")
        + _ops(*["DROP"] * 8)
    )


def _hmerge() -> list[Op]:
    return (
        _ops("PAD", "PAD", "PAD", "PAD", "SWAPW2", "SWAPW", "HPERM", "SWAPW2")
        + _ops(*["DROP"] * 8)
    )


def _read_mtree_node() -> list[Op]:
    return _sys_event("sys::merkle_node_to_stack") + _ops(
        "PAD", "PAD", "PAD", "PAD", "ADVPOPW"
    )


def _mtree_get() -> list[Op]:
    return _read_mtree_node() + [Op("MPVERIFY")] + _ops("MOVUP4", "DROP", "MOVUP4", "DROP")


def _mtree_set() -> list[Op]:
    # crypto_ops::update_mtree (30 cycles)
    return _read_mtree_node() + _ops(
        "MOVUP5", "MOVUP5", "DUP5", "DUP5", "SWAPDW", "SWAPW", "SWAPW2",
        "DUP13", "DUP13", "MRUPDATE",
        "MOVUP4", "DROP", "MOVUP4", "DROP",
        "SWAPW", "DROP", "DROP", "DROP", "DROP",
        "SWAPW", "DROP", "DROP", "DROP", "DROP",
        "SWAPW",
    )


# ext2_ops.rs ---------------------------------------------------------------


def _ext2_div() -> list[Op]:
    return (
        _sys_event("sys::ext2_inv")
        + _ops("ADVPOP", "ADVPOP", "EXT2MUL", "MOVUP3", "EQZ")
        + [_assert()]
        + _ops("MOVUP2")
        + [_assert()]
        + _ops("EXT2MUL", "DROP", "DROP")
    )


def _ext2_inv() -> list[Op]:
    return (
        _sys_event("sys::ext2_inv")
        + _ops("ADVPOP", "ADVPOP", "EXT2MUL", "MOVUP3", "EQZ")
        + [_assert()]
        + _ops("MOVUP2")
        + [_assert()]
    )


# stack manipulation tables (instruction/mod.rs:265-350) --------------------

_SWAP_N = {
    1: ("SWAP",),
    2: ("SWAP", "MOVUP2"),
    3: ("MOVDN2", "MOVUP3"),
    4: ("MOVDN3", "MOVUP4"),
    5: ("MOVDN4", "MOVUP5"),
    6: ("MOVDN5", "MOVUP6"),
    7: ("MOVDN6", "MOVUP7"),
    8: ("MOVDN7", "MOVUP8"),
    9: ("MOVDN8", "SWAPDW", "SWAP", "SWAPDW", "MOVUP8"),
    10: ("MOVDN8", "SWAPDW", "SWAP", "MOVUP2", "SWAPDW", "MOVUP8"),
    11: ("MOVDN8", "SWAPDW", "MOVDN2", "MOVUP3", "SWAPDW", "MOVUP8"),
    12: ("MOVDN8", "SWAPDW", "MOVDN3", "MOVUP4", "SWAPDW", "MOVUP8"),
    13: ("MOVDN8", "SWAPDW", "MOVDN4", "MOVUP5", "SWAPDW", "MOVUP8"),
    14: ("MOVDN8", "SWAPDW", "MOVDN5", "MOVUP6", "SWAPDW", "MOVUP8"),
    15: ("MOVDN8", "SWAPDW", "MOVDN6", "MOVUP7", "SWAPDW", "MOVUP8"),
}

_DUP_N = {
    **{n: (f"DUP{n}",) for n in (0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 15)},
    8: ("PAD", "DUP9", "ADD"),
    10: ("PAD", "DUP11", "ADD"),
    12: ("PAD", "DUP13", "ADD"),
    14: ("PAD", "DUP15", "ADD"),
}

_MOVUP_N = {
    **{n: (f"MOVUP{n}",) for n in range(2, 9)},
    9: ("SWAPDW", "SWAP", "SWAPDW", "MOVUP8"),
    **{n: ("SWAPDW", f"MOVUP{n - 8}", "SWAPDW", "MOVUP8") for n in range(10, 16)},
}

_MOVDN_N = {
    **{n: (f"MOVDN{n}",) for n in range(2, 9)},
    9: ("MOVDN8", "SWAPDW", "SWAP", "SWAPDW"),
    **{n: ("MOVDN8", "SWAPDW", f"MOVDN{n - 8}", "SWAPDW") for n in range(10, 16)},
}


# ---------------------------------------------------------------------------
# Module parsing
# ---------------------------------------------------------------------------


@dataclass
class Proc:
    name: str
    body: list[str]
    num_locals: int = 0
    exported: bool = False


@dataclass
class Module:
    path: str
    procs: dict[str, Proc] = field(default_factory=dict)
    consts: dict[str, int] = field(default_factory=dict)
    imports: dict[str, str] = field(default_factory=dict)
    entry: list[str] | None = None


_QUOTED = re.compile(r'"([^"]*)"')
_EVENT_CONST = re.compile(r'^event\("([^"]+)"\)$')


def _tokenize_line(line: str) -> list[str]:
    """Split a body line into tokens; quoted spans stay attached to their
    token (e.g. assert.err="out of bounds")."""
    out: list[str] = []
    buf = ""
    in_q = False
    for ch in line:
        if ch == '"':
            in_q = not in_q
            buf += ch
        elif ch.isspace() and not in_q:
            if buf:
                out.append(buf)
                buf = ""
        else:
            buf += ch
    if in_q:
        raise AssemblyError(f"unterminated string in: {line!r}")
    if buf:
        out.append(buf)
    return out


def _strip_comment(line: str) -> str:
    """Remove `#`/`#!` comments, respecting quoted strings."""
    in_q = False
    for i, ch in enumerate(line):
        if ch == '"':
            in_q = not in_q
        elif ch == "#" and not in_q:
            return line[:i]
    return line


def parse_module(path: str, source: str) -> Module:
    mod = Module(path)
    lines = [_strip_comment(ln).strip() for ln in source.splitlines()]
    i = 0

    def collect_body(start: int, seed: list[str]) -> tuple[list[str], int]:
        """Collect tokens (starting with the header line's remainder) until
        the `end` matching depth 0. Returns (body, next_line_index)."""
        depth = 0
        body: list[str] = []
        j = start
        queue = list(seed)
        while True:
            for k, tok in enumerate(queue):
                if tok in ("if.true", "if.false", "while.true") or tok.startswith(
                    "repeat."
                ):
                    depth += 1
                elif tok == "end":
                    if depth == 0:
                        if k + 1 < len(queue):
                            raise AssemblyError(
                                f"{path}: trailing tokens after `end`: {queue[k + 1 :]}"
                            )
                        return body, j
                    depth -= 1
                body.append(tok)
            if j >= len(lines):
                raise AssemblyError(f"{path}: missing `end`")
            queue = _tokenize_line(lines[j])
            j += 1

    pending_locals = 0
    while i < len(lines):
        line = lines[i]
        if not line:
            i += 1
            continue
        toks = _tokenize_line(line)
        head = toks[0]
        if head.startswith("@"):
            # procedure attributes; `@locals(N)` declares the local-frame
            # size of the following proc (assembly-syntax parser/cst/forms.rs)
            m = re.match(r"@locals\((\w+)\)$", head)
            if m:
                pending_locals = _parse_int(m.group(1), mod.consts)
            i += 1  # unknown attributes are ignored
        elif head == "use":
            if pending_locals:
                raise AssemblyError(
                    f"{path}: @locals must immediately precede a proc "
                    f"definition (found {head!r})"
                )
            # `use a::b::c` (binds c) or `use a::b::c as d`
            target = toks[1]
            alias = toks[3] if len(toks) >= 4 and toks[2] == "as" else target.rsplit(
                "::", 1
            )[-1]
            mod.imports[alias] = target
            i += 1
        elif head == "const" or head.startswith("const."):
            if pending_locals:
                raise AssemblyError(
                    f"{path}: @locals must immediately precede a proc "
                    f"definition (found {head!r})"
                )
            # `const NAME = expr` | `const.NAME=expr`
            text = line[len("const") :].lstrip(".").strip()
            name, _, expr = text.partition("=")
            name, expr = name.strip(), expr.strip()
            if not name or not expr:
                raise AssemblyError(f"{path}: malformed const: {line!r}")
            mod.consts[name] = _parse_const_expr(expr, mod.consts)
            i += 1
        elif head in ("proc", "export", "pub") or head.startswith(
            ("proc.", "export.")
        ):
            exported = head != "proc" and not head.startswith("proc.")
            seed: list[str] = []
            if head == "pub":
                if len(toks) < 3 or toks[1] != "proc":
                    raise AssemblyError(f"{path}: malformed pub proc: {line!r}")
                name = re.split(r"[(\s]", toks[2], 1)[0]
            elif "." in head:  # legacy `proc.name.locals` / `export.name.locals`
                parts = head.split(".")
                name = parts[1]
                num_locals = int(parts[2]) if len(parts) > 2 else pending_locals
                seed = toks[1:]
                body, i = collect_body(i + 1, seed)
                mod.procs[name] = Proc(name, body, num_locals, exported)
                pending_locals = 0
                continue
            else:
                name = re.split(r"[(\s]", toks[1], 1)[0]
            # a signature (if any) occupies the rest of the header line
            body, i = collect_body(i + 1, [])
            mod.procs[name] = Proc(name, body, pending_locals, exported)
            pending_locals = 0
        elif head == "begin":
            if pending_locals:
                raise AssemblyError(
                    f"{path}: @locals must immediately precede a proc "
                    "definition (found 'begin')"
                )
            body, i = collect_body(i + 1, toks[1:])
            mod.entry = body
        else:
            raise AssemblyError(f"{path}: unexpected top-level token {head!r}")
    return mod


def _parse_const_expr(expr: str, consts: dict[str, int]) -> int:
    m = _EVENT_CONST.match(expr)
    if m:
        return event_id(m.group(1))
    return _parse_int(expr, consts)


def _parse_int(text: str, consts: dict[str, int]) -> int:
    if text in consts:
        return consts[text]
    try:
        return int(text, 0)
    except ValueError as exc:
        raise AssemblyError(f"cannot parse value {text!r}") from exc


# ---------------------------------------------------------------------------
# Assembler
# ---------------------------------------------------------------------------


class Assembler:
    """Compiles MASM modules into a MastForest
    (crates/assembly/src/assembler.rs:784 Assembler::assemble_program)."""

    def __init__(self, kernel: str | None = None):
        """`kernel`: MASM source of the kernel module; every exported proc
        becomes a syscall target (assembler.rs with_kernel)."""
        self.modules: dict[str, Module] = {}
        self._kernel_mod = parse_module("$kernel", kernel) if kernel else None

    def add_module(self, path: str, source: str) -> None:
        self.modules[path] = parse_module(path, source)

    def add_library(self, modules: dict[str, str]) -> None:
        for path, source in modules.items():
            self.add_module(path, source)

    def assemble_program(self, source: str, path: str = "$exec") -> Program:
        mod = parse_module(path, source)
        if mod.entry is None:
            raise AssemblyError("executable module must contain a begin..end block")
        self.modules[path] = mod
        forest = MastForest()
        ctx = _CompileContext(self, forest)
        # compile the full kernel first: every kernel procedure is part of
        # the kernel ROM (declared even if never called)
        kernel_digests: tuple = ()
        if self._kernel_mod is not None:
            digests = []
            for name in self._kernel_mod.procs:
                node = ctx.compile_proc(self._kernel_mod, name)
                digests.append(forest[node].digest)
            kernel_digests = tuple(digests)
        # every program entrypoint initializes the frame pointer
        # (crates/assembly/src/assembler.rs:1341-1349)
        root = ctx.compile_body(mod, list(mod.entry), prologue=_fmp_init())
        forest.make_root(root)
        return Program(forest, root, kernel_digests)


class _CompileContext:
    def __init__(self, asm: Assembler, forest: MastForest):
        self.asm = asm
        self.forest = forest
        self._compiled: dict[tuple[str, str], int] = {}
        self._in_progress: set[tuple[str, str]] = set()
        self._num_locals = 0  # local-frame size of the proc being compiled

    # -- procedure resolution ----------------------------------------------

    def compile_proc(self, mod: Module, name: str) -> int:
        key = (mod.path, name)
        if key in self._compiled:
            return self._compiled[key]
        if key in self._in_progress:
            raise AssemblyError(f"recursive procedure {name} in {mod.path}")
        proc = mod.procs.get(name)
        if proc is None:
            raise AssemblyError(f"procedure {name} not found in {mod.path}")
        self._in_progress.add(key)
        saved_locals = self._num_locals
        self._num_locals = proc.num_locals
        # BodyWrapper (crates/assembly/src/assembler.rs:1350-1356): frame
        # allocation prologue/epilogue around procedures with locals
        if proc.num_locals:
            node = self.compile_body(
                mod,
                list(proc.body),
                prologue=_fmp_frame(proc.num_locals, True),
                epilogue=_fmp_frame(proc.num_locals, False),
            )
        else:
            node = self.compile_body(mod, list(proc.body))
        self._num_locals = saved_locals
        self._in_progress.discard(key)
        self._compiled[key] = node
        return node

    def resolve_target(self, mod: Module, target: str) -> int:
        if "::" in target:
            alias, _, name = target.rpartition("::")
            path = mod.imports.get(alias, alias)
            target_mod = self.asm.modules.get(path)
            if target_mod is None:
                raise AssemblyError(f"module {path} not found (import {alias!r})")
            return self.compile_proc(target_mod, name)
        return self.compile_proc(mod, target)

    # -- body compilation --------------------------------------------------

    def compile_body(
        self,
        mod: Module,
        tokens: list[str],
        prologue: list[Op] | None = None,
        epilogue: list[Op] | None = None,
    ) -> int:
        nodes, _ = self._compile_items(mod, tokens, 0, ())
        if prologue:
            nodes.insert(0, self.forest.add_block(list(prologue)))
        if epilogue:
            nodes.append(self.forest.add_block(list(epilogue)))
        if not nodes:
            nodes = [self.forest.add_block([Op("NOOP")])]
        return self._join(nodes)

    def _join(self, nodes: list[int]) -> int:
        """Binary-tree join (mast_forest_builder.rs:790)."""
        while len(nodes) > 1:
            tail = nodes.pop() if len(nodes) % 2 else None
            nodes = [
                self.forest.add_join(nodes[k], nodes[k + 1])
                for k in range(0, len(nodes), 2)
            ]
            if tail is not None:
                nodes.append(tail)
        return nodes[0]

    def _compile_items(
        self, mod: Module, tokens: list[str], i: int, stop: tuple
    ) -> tuple[list[int], int]:
        nodes: list[int] = []
        pending: list[Op] = []

        def flush():
            if pending:
                nodes.append(self.forest.add_block(list(pending)))
                pending.clear()

        while i < len(tokens):
            tok = tokens[i]
            if tok in stop:
                flush()
                return nodes, i
            i += 1
            if tok in ("if.true", "if.false"):
                flush()
                then_nodes, i = self._compile_items(mod, tokens, i, ("else", "end"))
                then_id = self._join(then_nodes) if then_nodes else self._noop()
                if tokens[i] == "else":
                    else_nodes, i = self._compile_items(mod, tokens, i + 1, ("end",))
                    else_id = self._join(else_nodes) if else_nodes else self._noop()
                else:
                    else_id = self._noop()
                i += 1  # consume `end`
                if tok == "if.false":
                    then_id, else_id = else_id, then_id
                nodes.append(self.forest.add_split(then_id, else_id))
            elif tok == "while.true":
                # `while.true` desugars to `if.true { LOOP { body } } else
                # { noop }` — the LOOP node itself is do-while
                # (crates/assembly/src/assembler.rs:1514-1516)
                flush()
                body_nodes, i = self._compile_items(mod, tokens, i, ("end",))
                body = self._join(body_nodes) if body_nodes else self._noop()
                i += 1
                loop_node = self.forest.add_loop(body)
                nodes.append(self.forest.add_split(loop_node, self._noop()))
            elif tok.startswith("repeat."):
                # compile-time unroll: splice the body back into the token
                # stream so contiguous ops merge with the surroundings
                count = _parse_int(tok[len("repeat.") :], mod.consts)
                end_idx = _find_matching_end(tokens, i)
                body_toks = tokens[i:end_idx]
                tokens = tokens[: i - 1] + body_toks * count + tokens[end_idx + 1 :]
                i -= 1
            elif tok.startswith("exec."):
                flush()
                nodes.append(self.resolve_target(mod, tok[len("exec.") :]))
            elif tok.startswith("call."):
                flush()
                callee = self.resolve_target(mod, tok[len("call.") :])
                nodes.append(self.forest.add_call(callee))
            elif tok.startswith("syscall."):
                flush()
                kmod = self.asm._kernel_mod
                if kmod is None:
                    raise AssemblyError("syscall used but no kernel is linked")
                callee = self.compile_proc(kmod, tok[len("syscall.") :])
                nodes.append(self.forest.add_call(callee, is_syscall=True))
            elif tok.startswith("procref."):
                flush()
                target = self.resolve_target(mod, tok[len("procref.") :])
                digest = self.forest[target].digest
                for felt in reversed(digest):
                    pending.extend(_push_felt(felt))
            elif tok == "end":
                raise AssemblyError("unexpected `end`")
            else:
                pending.extend(self._lower(mod, tok))
        flush()
        if stop:
            raise AssemblyError(f"missing one of {stop}")
        return nodes, i

    def _noop(self) -> int:
        return self.forest.add_block([Op("NOOP")])

    # -- instruction lowering ----------------------------------------------

    def _lower(self, mod: Module, tok: str) -> list[Op]:  # noqa: C901
        consts = mod.consts
        # pull off a quoted / named error suffix: inst.err="..." | inst.err=CONST
        err = 0
        m = re.search(r'\.err=("([^"]*)"|\w+)$', tok)
        if m:
            err = (
                error_code_from_msg(m.group(2))
                if m.group(2) is not None
                else _parse_int(m.group(1), consts)
            )
            tok = tok[: m.start()]
        parts = tok.split(".")
        name, args = parts[0], parts[1:]

        def iargs() -> list[int]:
            return [_parse_int(a, consts) for a in args]

        simple = _SIMPLE_INSTRUCTIONS.get(tok)
        if simple is not None:
            return _ops(*simple)
        loc_suffix = _LOC_INSTRUCTIONS.get(name)
        if loc_suffix is not None:
            # procedure-local accesses resolve against the current frame
            # (instruction/mem_ops.rs:28-117, env_ops.rs:110)
            idx = iargs()[0]
            is_single = name in ("locaddr", "loc_load", "loc_store")
            addr = _local_addr(idx, self._num_locals, is_single)
            if name == "loc_storew_be":
                return _reversew() + addr + _ops("MSTOREW") + _reversew()
            return addr + _ops(*loc_suffix)
        table = _LOWERINGS.get(name)
        if table is not None:
            return table(args, iargs, err, consts)
        raise AssemblyError(f"unknown instruction {tok!r}")


# ---------------------------------------------------------------------------
# Instruction tables
# ---------------------------------------------------------------------------

# local-frame access: op suffix appended after the absolute-address sequence
# (loc_storew_be needs pre/post word reversal and is special-cased)
_LOC_INSTRUCTIONS: dict[str, tuple[str, ...]] = {
    "locaddr": (),
    "loc_load": ("MLOAD",),
    "loc_store": ("MSTORE", "DROP"),
    "loc_loadw_le": ("MLOADW",),
    "loc_loadw_be": ("MLOADW", "MOVDN3", "SWAP", "MOVUP2"),
    "loc_storew_le": ("MSTOREW",),
    "loc_storew_be": (),
}

# exact-token → op-name sequence (no immediates)
_SIMPLE_INSTRUCTIONS: dict[str, tuple[str, ...]] = {
    "nop": ("NOOP",),
    "assertz": ("EQZ", "ASSERT"),
    "assert_eq": ("EQ", "ASSERT"),
    "asserteq": ("EQ", "ASSERT"),
    "add": ("ADD",),
    "sub": ("NEG", "ADD"),
    "mul": ("MUL",),
    "div": ("INV", "MUL"),
    "neg": ("NEG",),
    "inv": ("INV",),
    "not": ("NOT",),
    "and": ("AND",),
    "or": ("OR",),
    "xor": ("DUP0", "DUP2", "OR", "MOVDN2", "AND", "NOT", "AND"),
    "eq": ("EQ",),
    "neq": ("EQ", "NOT"),
    "eqz": ("EQZ",),
    # u32 tests / casts (instruction/mod.rs:166-186)
    "u32test": ("DUP0", "U32SPLIT", "DROP", "EQZ"),
    "u32cast": ("U32SPLIT", "SWAP", "DROP"),
    "u32split": ("U32SPLIT",),
    "u32assert": ("PAD", "U32ASSERT2", "DROP"),
    "u32assert2": ("U32ASSERT2",),
    "u32overflowing_add3": ("U32ADD3", "SWAP"),
    "u32widening_add3": ("U32ADD3",),
    "u32wrapping_add3": ("U32ADD3", "SWAP", "DROP"),
    "u32widening_madd": ("U32MADD",),
    "u32wrapping_madd": ("U32MADD", "SWAP", "DROP"),
    "u32and": ("U32AND",),
    "u32or": ("DUP1", "DUP1", "U32AND", "NEG", "ADD", "ADD"),
    "u32xor": ("U32XOR",),
    "u32lt": ("U32SUB", "SWAP", "DROP"),
    "u32lte": ("SWAP", "U32SUB", "SWAP", "DROP", "NOT"),
    "u32gt": ("SWAP", "U32SUB", "SWAP", "DROP"),
    "u32gte": ("U32SUB", "SWAP", "DROP", "NOT"),
    "u32min": ("DUP1", "DUP1", "U32SUB", "SWAP", "DROP", "EQZ", "CSWAP", "DROP"),
    "u32max": (
        "DUP1", "DUP1", "U32SUB", "SWAP", "DROP", "EQZ", "CSWAP", "SWAP", "DROP",
    ),
    # stack
    "drop": ("DROP",),
    "dropw": ("DROP", "DROP", "DROP", "DROP"),
    "padw": ("PAD", "PAD", "PAD", "PAD"),
    "swapw": ("SWAPW",),
    "swapdw": ("SWAPDW",),
    "cswap": ("CSWAP",),
    "cswapw": ("CSWAPW",),
    "cdrop": ("CSWAP", "DROP"),
    "cdropw": ("CSWAPW", "DROP", "DROP", "DROP", "DROP"),
    "reversew": ("MOVDN3", "SWAP", "MOVUP2"),
    "reversedw": (
        "MOVDN3", "SWAP", "MOVUP2", "SWAPW", "MOVDN3", "SWAP", "MOVUP2",
    ),
    # env / io (instruction/mod.rs:356-400)
    "sdepth": ("SDEPTH",),
    "caller": ("CALLER",),
    "clk": ("CLK",),
    "adv_pipe": ("PIPE",),
    "adv_pushw": ("PAD", "PAD", "PAD", "PAD", "ADVPOPW"),
    "adv_loadw": ("ADVPOPW",),
    "mem_stream": ("MSTREAM",),
    "mem_load": ("MLOAD",),
    "mem_store": ("MSTORE", "DROP"),
    "mem_loadw_le": ("MLOADW",),
    "mem_loadw_be": ("MLOADW", "MOVDN3", "SWAP", "MOVUP2"),
    "mem_storew_le": ("MSTOREW",),
    "mem_storew_be": (
        "MOVDN4", "MOVDN3", "SWAP", "MOVUP2", "MOVUP4", "MSTOREW",
        "MOVDN3", "SWAP", "MOVUP2",
    ),
    # crypto
    "hperm": ("HPERM",),
    "mtree_verify": ("MPVERIFY",),
    "cryptostream": ("CRYPTOSTREAM",),
    "crypto_stream": ("CRYPTOSTREAM",),
    # STARK verification ops
    "fri_ext2fold4": ("FRIE2F4",),
    "horner_eval_base": ("HORNERBASE",),
    "horner_eval_ext": ("HORNEREXT",),
    "eval_circuit": ("EVALCIRCUIT",),
    "log_deferred": ("LOGDEFERRED",),
    "emit": ("EMIT",),
    "expacc": ("EXPACC",),
    "ext2mul": ("EXT2MUL", "DROP", "DROP"),
    "ext2add": ("SWAP", "MOVUP3", "ADD", "MOVDN2", "ADD"),
    "ext2sub": ("NEG", "SWAP", "NEG", "MOVUP3", "ADD", "MOVDN2", "ADD"),
    "ext2neg": ("NEG", "SWAP", "NEG", "SWAP"),
    "is_odd": ("U32SPLIT", "SWAP", "DROP", "PAD", "INCR", "U32AND"),
    # system events (adv.* — parser/cst/instructions.rs:157-193)
    "u32testw": (
        "DUP3", "U32SPLIT", "DROP", "EQZ",
        "DUP3", "U32SPLIT", "DROP", "EQZ", "AND",
        "DUP2", "U32SPLIT", "DROP", "EQZ", "AND",
        "DUP1", "U32SPLIT", "DROP", "EQZ", "AND",
    ),
    "u32not": (),  # handled in _LOWERINGS (needs immediates)
}
del _SIMPLE_INSTRUCTIONS["u32not"]

_ADV_EVENTS = {
    "insert_hdword": "sys::hdword_to_map",
    "insert_hdword_d": "sys::hdword_to_map_with_domain",
    "insert_hperm": "sys::hperm_to_map",
    "insert_hqword": "sys::hqword_to_map",
    "insert_mem": "sys::mem_to_map",
    "push_mapval": "sys::map_value_to_stack",
    "push_mapval_count": "sys::map_value_count_to_stack",
    "push_mapvaln": "sys::map_value_to_stack_n_0",
    "push_mtnode": "sys::merkle_node_to_stack",
    "has_mapkey": "sys::has_map_key",
}


def _lower_adv(args, iargs, err, consts):
    sub = args[0]
    if sub == "push_mapvaln" and len(args) > 1:
        return _sys_event(f"sys::map_value_to_stack_n_{args[1]}")
    ev = _ADV_EVENTS.get(sub)
    if ev is None:
        raise AssemblyError(f"unknown adv event {sub!r}")
    return _sys_event(ev)


def _lower_push(args, iargs, err, consts):
    out: list[Op] = []
    for v in iargs():
        out += _push_felt(v)
    if not out:
        raise AssemblyError("push requires at least one immediate")
    return out


def _one_imm(iargs) -> int | None:
    vals = iargs()
    if len(vals) > 1:
        raise AssemblyError("too many immediates")
    return vals[0] if vals else None


def _lower_add(args, iargs, err, consts):
    imm = _one_imm(iargs)
    if imm is None:
        return _ops("ADD")
    imm %= P
    if imm == 0:
        return _ops("NOOP")
    if imm == 1:
        return _ops("INCR")
    if imm == 2:
        return _ops("INCR", "INCR")
    return [Op("PUSH", imm), Op("ADD")]


def _lower_sub(args, iargs, err, consts):
    imm = _one_imm(iargs)
    if imm is None:
        return _ops("NEG", "ADD")
    imm %= P
    return _ops("NOOP") if imm == 0 else [Op("PUSH", P - imm), Op("ADD")]


def _lower_mul(args, iargs, err, consts):
    imm = _one_imm(iargs)
    if imm is None:
        return _ops("MUL")
    imm %= P
    if imm == 0:
        return _ops("DROP", "PAD")
    if imm == 1:
        return _ops("NOOP")
    return [Op("PUSH", imm), Op("MUL")]


def _lower_div(args, iargs, err, consts):
    imm = _one_imm(iargs)
    if imm is None:
        return _ops("INV", "MUL")
    imm %= P
    if imm == 0:
        raise AssemblyError("division by zero")
    if imm == 1:
        return _ops("NOOP")
    return [Op("PUSH", pow(imm, P - 2, P)), Op("MUL")]


def _lower_eq(args, iargs, err, consts):
    imm = _one_imm(iargs)
    if imm is None:
        return _ops("EQ")
    return _ops("EQZ") if imm % P == 0 else [Op("PUSH", imm), Op("EQ")]


def _lower_neq(args, iargs, err, consts):
    imm = _one_imm(iargs)
    if imm is None:
        return _ops("EQ", "NOT")
    if imm % P == 0:
        return _ops("EQZ", "NOT")
    return [Op("PUSH", imm), Op("EQ"), Op("NOT")]


def _cmp_lowering(fn):
    def lower(args, iargs, err, consts):
        imm = _one_imm(iargs)
        return ([Op("PUSH", imm)] if imm is not None else []) + fn()

    return lower


def _lower_exp(args, iargs, err, consts):
    if not args:
        return _exp_bits(64)
    if args[0].startswith("u"):
        return _exp_bits(int(args[0][1:]))
    return _exp_imm(_parse_int(args[0], consts))


def _lower_assert(args, iargs, err, consts):
    return [_assert(err)]


def _lower_assert_eq(args, iargs, err, consts):
    return [Op("EQ"), _assert(err)]


def _lower_assert_eqw(args, iargs, err, consts):
    return _assertw(err)


def _lower_assertz(args, iargs, err, consts):
    return [Op("EQZ"), _assert(err)]


def _lower_u32assert2(args, iargs, err, consts):
    return [Op("U32ASSERT2", err_code=err)]


def _lower_u32assert(args, iargs, err, consts):
    return [Op("PAD"), Op("U32ASSERT2", err_code=err), Op("DROP")]


def _lower_u32assertw(args, iargs, err, consts):
    return [
        Op("U32ASSERT2", err_code=err),
        Op("MOVUP3"), Op("MOVUP3"),
        Op("U32ASSERT2", err_code=err),
        Op("MOVUP3"), Op("MOVUP3"),
    ]


def _lower_mtree_verify(args, iargs, err, consts):
    return [Op("MPVERIFY", err_code=err)]


def _find_matching_end(tokens: list[str], start: int) -> int:
    depth = 0
    for j in range(start, len(tokens)):
        tok = tokens[j]
        if tok in ("if.true", "if.false", "while.true") or tok.startswith("repeat."):
            depth += 1
        elif tok == "end":
            if depth == 0:
                return j
            depth -= 1
    raise AssemblyError("missing `end`")


def _stack_table(table, label, default=None):
    def lower(args, iargs, err, consts):
        imm = _one_imm(iargs)
        if imm is None:
            imm = default
        if imm not in table:
            raise AssemblyError(f"{label}.{imm}: index out of range")
        return _ops(*table[imm])

    return lower


def _lower_dupw(args, iargs, err, consts):
    n = _one_imm(iargs) or 0
    if n not in (0, 1, 2, 3):
        raise AssemblyError(f"dupw.{n}: out of range")
    dup = {0: "DUP3", 1: "DUP7", 2: "DUP11", 3: "DUP15"}[n]
    return _ops(*[dup] * 4)


def _lower_swapw(args, iargs, err, consts):
    n = _one_imm(iargs)
    if n is None or n == 1:
        return _ops("SWAPW")
    if n == 2:
        return _ops("SWAPW2")
    if n == 3:
        return _ops("SWAPW3")
    raise AssemblyError(f"swapw.{n}: out of range")


def _lower_movupw(args, iargs, err, consts):
    n = _one_imm(iargs)
    if n == 2:
        return _ops("SWAPW", "SWAPW2")
    if n == 3:
        return _ops("SWAPW", "SWAPW2", "SWAPW3")
    raise AssemblyError(f"movupw.{n}: out of range")


def _lower_movdnw(args, iargs, err, consts):
    n = _one_imm(iargs)
    if n == 2:
        return _ops("SWAPW2", "SWAPW")
    if n == 3:
        return _ops("SWAPW3", "SWAPW2", "SWAPW")
    raise AssemblyError(f"movdnw.{n}: out of range")


def _mem_access(op_names, imm_is_word: bool = False):
    def lower(args, iargs, err, consts):
        imm = _one_imm(iargs)
        out: list[Op] = []
        if imm is not None:
            out += _push_u32(imm)
        return out + _ops(*op_names)

    return lower


def _lower_u32_arith_factory(op, mode):
    def lower(args, iargs, err, consts):
        return _u32_arith(op, mode, _one_imm(iargs))

    return lower


def _lower_u32_div_factory(kind):
    def lower(args, iargs, err, consts):
        return _u32_division(kind, _one_imm(iargs))

    return lower


def _lower_u32shl(args, iargs, err, consts):
    imm = _one_imm(iargs)
    out = _prepare_bitwise(imm)
    if imm != 0:
        out += _ops("U32MUL", "SWAP", "DROP")
    return out


def _lower_u32shr(args, iargs, err, consts):
    imm = _one_imm(iargs)
    out = _prepare_bitwise(imm)
    if imm != 0:
        out += _ops("U32DIV", "DROP")
    return out


def _lower_u32rotl(args, iargs, err, consts):
    imm = _one_imm(iargs)
    out = _prepare_bitwise(imm)
    if imm != 0:
        out += _ops("U32MUL", "ADD")
    return out


def _lower_u32rotr(args, iargs, err, consts):
    imm = _one_imm(iargs)
    if imm == 0:
        return _ops("NOOP")
    if imm is not None:
        if imm > 31:
            raise AssemblyError(f"u32rotr.{imm}: out of range")
        return [Op("PUSH", 1 << (32 - imm))] + _ops("U32MUL", "ADD")
    return (
        [Op("PUSH", 32)]
        + _ops("SWAP", "U32SUB", "DROP")
        + _pow2()
        + _ops("MUL", "U32SPLIT", "ADD")
    )


def _lower_u32not(args, iargs, err, consts):
    return (
        [Op("PUSH", 0xFFFFFFFF), Op("U32ASSERT2")]
        + _ops("SWAP", "U32SUB", "DROP")
    )


def _assert_le_32() -> list[Op]:
    """[c, ...] -> [c, ...] asserting c <= 32 (also range-checks c)."""
    return (
        [Op("DUP0"), Op("PUSH", 32)]
        + _ops("SWAP", "U32SUB", "SWAP", "DROP", "NOT")
        + [_assert()]
    )


def _verify_clz_ops() -> list[Op]:
    """Own nondeterminism check for clz (reference uses a leading-ones
    bitmask, u32_ops.rs:530; ours multiplies instead): with c <= 32,
    m = n * 2^c <= (2^32-1) * 2^32 < p fits the field exactly, and c is
    correct iff hi32(m) == 0 and (lo32(m) >= 2^31 or (n == 0 and c == 32)).
    [c, n] -> [c]."""
    return (
        _assert_le_32()
        + _ops("DUP1", "DUP1")
        + _pow2()
        + _ops("MUL", "U32SPLIT", "SWAP", "EQZ")  # [m_lo, c, n] after assert
        + [_assert(), Op("DUP0"), Op("PUSH", 1 << 31)]
        + _ops("U32SUB", "SWAP", "DROP", "NOT")  # m_lo >= 2^31
        + _ops("SWAP", "DROP", "MOVUP2", "EQZ")  # [n==0, ge, c]
        + [Op("DUP2"), Op("PUSH", 32)]
        + _ops("EQ", "AND", "OR")
        + [_assert()]
    )


def _verify_ctz_ops() -> list[Op]:
    """Own check for ctz: with c <= 32, m = n * 2^(32-c) < p; c is correct
    iff lo32(m) == 0 and (hi32(m) odd or (n == 0 and c == 32)).
    [c, n] -> [c]."""
    return (
        _assert_le_32()
        + [Op("DUP0"), Op("PUSH", 32)]
        + _ops("SWAP", "NEG", "ADD")  # 32 - c
        + _pow2()
        + _ops("DUP2", "MUL", "U32SPLIT", "EQZ")  # lo32(m) == 0
        + [_assert(), Op("DUP0"), Op("PUSH", 2)]
        + _ops("U32DIV", "SWAP", "DROP")  # remainder = hi32(m) & 1
        + _ops("MOVUP3", "EQZ")  # [n==0, bit, m_hi, c]
        + [Op("DUP3"), Op("PUSH", 32)]
        + _ops("EQ", "AND", "OR")
        + [_assert(), Op("DROP")]
    )


def _lower_u32clz_family(kind: str):
    """u32clz/u32ctz/u32clo/u32cto: host event supplies the count, the
    in-block sequence verifies it (u32_ops.rs:399-435; clo/cto reduce to
    clz/ctz of the complement)."""

    def lower(args, iargs, err, consts):
        base = kind[-3:]  # clz | ctz | clo | cto
        complement = base in ("clo", "cto")
        verify = (
            _verify_clz_ops() if base in ("clz", "clo") else _verify_ctz_ops()
        )
        out = _sys_event(f"sys::u32_{base}") + _ops("ADVPOP")
        if complement:
            out += _ops("SWAP") + _lower_u32not((), lambda: [], 0, consts)
            out += _ops("SWAP")
        return out + verify

    return lower


def _lower_ilog2(args, iargs, err, consts):
    raise AssemblyError("ilog2 verification sequence not supported yet")


def _lower_adv_push(args, iargs, err, consts):
    """adv_push.n → n × ADVPOP (assembly/src/instruction/mod.rs AdvPush)."""
    n = _one_imm(iargs)
    if n is None or not 1 <= n <= 16:
        raise AssemblyError(f"adv_push.{n}: immediate must be in 1..=16")
    return _ops(*["ADVPOP"] * n)


_LOWERINGS = {
    "adv": _lower_adv,
    "adv_push": _lower_adv_push,
    "push": _lower_push,
    "add": _lower_add,
    "sub": _lower_sub,
    "mul": _lower_mul,
    "div": _lower_div,
    "eq": _lower_eq,
    "neq": _lower_neq,
    "lt": _cmp_lowering(_lt),
    "lte": _cmp_lowering(_lte),
    "gt": _cmp_lowering(_gt),
    "gte": _cmp_lowering(_gte),
    "pow2": lambda a, i, e, c: _pow2(),
    "exp": _lower_exp,
    "ilog2": _lower_ilog2,
    "assert": _lower_assert,
    "assert_eq": _lower_assert_eq,
    "assert_eqw": _lower_assert_eqw,
    "assertz": _lower_assertz,
    "eqw": lambda a, i, e, c: _eqw(),
    "u32assert": _lower_u32assert,
    "u32assert2": _lower_u32assert2,
    "u32assertw": _lower_u32assertw,
    "u32overflowing_add": _lower_u32_arith_factory("U32ADD", "overflowing"),
    "u32widening_add": _lower_u32_arith_factory("U32ADD", "widening"),
    "u32wrapping_add": _lower_u32_arith_factory("U32ADD", "wrapping"),
    "u32overflowing_sub": _lower_u32_arith_factory("U32SUB", "overflowing"),
    "u32wrapping_sub": _lower_u32_arith_factory("U32SUB", "wrapping"),
    "u32widening_mul": _lower_u32_arith_factory("U32MUL", "widening"),
    "u32wrapping_mul": _lower_u32_arith_factory("U32MUL", "wrapping"),
    "u32div": _lower_u32_div_factory("div"),
    "u32mod": _lower_u32_div_factory("mod"),
    "u32divmod": _lower_u32_div_factory("divmod"),
    "u32shl": _lower_u32shl,
    "u32shr": _lower_u32shr,
    "u32rotl": _lower_u32rotl,
    "u32rotr": _lower_u32rotr,
    "u32not": _lower_u32not,
    "u32popcnt": lambda a, i, e, c: _u32popcnt(),
    "u32clz": _lower_u32clz_family("u32clz"),
    "u32ctz": _lower_u32clz_family("u32ctz"),
    "u32clo": _lower_u32clz_family("u32clo"),
    "u32cto": _lower_u32clz_family("u32cto"),
    "dup": _stack_table(_DUP_N, "dup", default=0),
    "swap": _stack_table(_SWAP_N, "swap", default=1),
    "movup": _stack_table(_MOVUP_N, "movup"),
    "movdn": _stack_table(_MOVDN_N, "movdn"),
    "dupw": _lower_dupw,
    "swapw": _lower_swapw,
    "movupw": _lower_movupw,
    "movdnw": _lower_movdnw,
    "mem_load": _mem_access(("MLOAD",)),
    "mem_store": _mem_access(("MSTORE", "DROP")),
    "mem_loadw_le": _mem_access(("MLOADW",)),
    "mem_loadw_be": _mem_access(("MLOADW", "MOVDN3", "SWAP", "MOVUP2")),
    "mem_storew_le": _mem_access(("MSTOREW",)),
    "mem_storew_be": lambda a, i, e, c: (
        _reversew() + _push_u32(_one_imm(i)) + _ops("MSTOREW") + _reversew()
    ),
    "hash": lambda a, i, e, c: _hash_1to1(),
    "hmerge": lambda a, i, e, c: _hmerge(),
    "mtree_get": lambda a, i, e, c: _mtree_get(),
    "mtree_set": lambda a, i, e, c: _mtree_set(),
    "mtree_merge": lambda a, i, e, c: _sys_event("sys::merkle_node_merge") + _hmerge(),
    "mtree_verify": _lower_mtree_verify,
    "ext2div": lambda a, i, e, c: _ext2_div(),
    "ext2inv": lambda a, i, e, c: _ext2_inv(),
    "emit": lambda a, i, e, c: (
        [Op("PUSH", i()[0]), Op("EMIT"), Op("DROP")] if a else _ops("EMIT")
    ),
}


def assemble(source: str, **kwargs) -> Program:
    """One-shot helper: assemble an executable MASM module."""
    return Assembler(**kwargs).assemble_program(source)
