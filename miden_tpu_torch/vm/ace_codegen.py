"""ACE circuit codegen: compile an Air's constraint fold into the VM's
arithmetic-circuit-evaluation format.

Re-designs the reference's ace-codegen crate
(crates/ace-codegen/src/lib.rs:1-31 — SymbolicAirBuilder capture →
verifier-style DAG → encoded ACE circuit) against this framework's own
constraint IR: the same base-field SSA recording the chunked constraint
interpreter uses (stark/interp.py RecordBackend) is lowered to the ACE
chiplet's QuadFelt instruction stream (vm/processor.py EVALCIRCUIT,
execution/operations/eval_circuit.rs:31-110, 30-bit node ids,
op ∈ {sub, mul, add}).

Base-field arithmetic embeds losslessly in the quadratic extension: a
base value x rides as the node (x, 0) — quad add/sub act componentwise
and (x, 0)·(y, 0) = (xy, 0) — so every recorded SSA instruction maps to
exactly one ACE gate. The recorded fold's (lo, hi) register pair is
recombined with the constant node X = (0, 1) (lo + hi·X), and the final
gate subtracts the caller-provided ``expected`` input, so the circuit
evaluates to zero exactly when the Air's α-folded constraint value at
the given evaluation point equals ``expected``.

This is the recursion building block: an in-VM program EVALCIRCUITs the
verifier's constraint check instead of re-implementing the AIR in MASM,
and the ACE chiplet proves the evaluation. Input layout (quad node
order, highest ACE id first) follows interp.ConstraintProgram:

  main cur (w) | main next (w) | pp cur/next | aux cur/next (2 each) |
  selectors (3) | periodic (p) | publics | randomness (2 each) |
  aux_values (2 each) | alpha (2) | [interned constants...] |
  X = (0, 1) | expected (one quad)
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import gl
from ..stark.interp import OP_ADD, OP_MUL, OP_SUB, RecordBackend, _collect_constants

ACE_MAX_ID = (1 << 30) - 1

#: ACE gate opcodes (eval_circuit.rs / processor EVALCIRCUIT)
ACE_SUB, ACE_MUL, ACE_ADD = 0, 1, 2

_OP_TO_ACE = {OP_SUB: ACE_SUB, OP_MUL: ACE_MUL, OP_ADD: ACE_ADD}


@dataclass
class AceCircuit:
    """An encoded ACE circuit for one Air's constraint fold.

    ``n_inputs`` leading variable slots are caller-provided base values
    (the interp input layout above); the remaining variable slots are
    the circuit's interned constants, X = (0, 1), ``expected`` (caller
    provides its quad value at build time of the var section), and an
    optional parity pad."""

    air_name: str
    n_inputs: int
    const_values: tuple  # interned base constants, in variable order
    num_vars: int  # quad variable count (even)
    num_eval: int  # gate count (multiple of 4)
    instr_words: tuple  # encoded gates, memory order

    @property
    def total_nodes(self) -> int:
        return self.num_vars + self.num_eval

    # -- variable section ---------------------------------------------------

    def var_felts(self, inputs, expected) -> list[int]:
        """The variable memory section (num_vars quads = 2·num_vars
        felts, word-aligned) for base ``inputs`` (length n_inputs) and
        the ``expected`` quad."""
        assert len(inputs) == self.n_inputs
        quads = [(int(v) % gl.P, 0) for v in inputs]
        quads += [(c, 0) for c in self.const_values]
        quads.append((0, 1))  # X
        quads.append((int(expected[0]) % gl.P, int(expected[1]) % gl.P))
        while len(quads) < self.num_vars:
            quads.append((0, 0))  # parity pad
        assert len(quads) == self.num_vars
        return [v for q in quads for v in q]

    # -- host evaluation (differential reference) ----------------------------

    def evaluate(self, inputs, expected) -> bool:
        """Runs the circuit host-side with EVALCIRCUIT semantics;
        returns True when node 0 evaluates to (0, 0)."""
        felts = self.var_felts(inputs, expected)
        total = self.total_nodes
        values = {}
        nid = total - 1
        for i in range(self.num_vars):
            values[nid] = (felts[2 * i], felts[2 * i + 1])
            nid -= 1
        for ins in self.instr_words:
            id_l = ins & ACE_MAX_ID
            id_r = (ins >> 30) & ACE_MAX_ID
            opv = ins >> 60
            vl, vr = values[id_l], values[id_r]
            if opv == ACE_SUB:
                v = gl.ext_sub(vl, vr)
            elif opv == ACE_MUL:
                v = gl.ext_mul(vl, vr)
            else:
                v = gl.ext_add(vl, vr)
            values[nid] = v
            nid -= 1
        return values[0] == (0, 0)


def build_ace_circuit(
    air, n_pub: int, n_rand: int, n_auxv: int
) -> AceCircuit:
    """Records ``air``'s constraint fold and encodes it as an ACE
    circuit asserting ``fold(inputs) == expected``."""
    from ..stark.air import Expr, Folder

    w, aw, p = air.width, air.aux_width, len(air.periodic_columns)
    pw = air.preprocessed_width
    n_inputs = (
        2 * w + 2 * pw + 4 * aw + 3 + p + n_pub + 2 * n_rand + 2 * n_auxv + 2
    )

    be = RecordBackend(n_inputs)
    for c in [0, 1, 7] + _collect_constants(air, n_pub, n_rand, n_auxv):
        be.intern(c)
    be.seal()

    nxt = iter(range(n_inputs)).__next__
    main_cur = [nxt() for _ in range(w)]
    main_next = [nxt() for _ in range(w)]
    pp_cur = [nxt() for _ in range(pw)]
    pp_next = [nxt() for _ in range(pw)]
    aux_cur = [(nxt(), nxt()) for _ in range(aw)]
    aux_next = [(nxt(), nxt()) for _ in range(aw)]
    sels = tuple(nxt() for _ in range(3))
    periodic = [nxt() for _ in range(p)]
    pubs = [nxt() for _ in range(n_pub)]
    rands = [(nxt(), nxt()) for _ in range(n_rand)]
    auxvs = [(nxt(), nxt()) for _ in range(n_auxv)]
    alpha = (nxt(), nxt())

    f = Folder(
        be,
        main_fn=lambda c, o=0: Expr(be, "base", (main_next if o else main_cur)[c]),
        aux_fn=lambda c, o=0: Expr(be, "ext", (aux_next if o else aux_cur)[c]),
        preprocessed_fn=lambda c, o=0: Expr(
            be, "base", (pp_next if o else pp_cur)[c]
        ),
        periodic=[Expr(be, "base", r) for r in periodic],
        publics=[Expr(be, "base", r) for r in pubs],
        randomness=[Expr(be, "ext", r) for r in rands],
        aux_values=[Expr(be, "ext", r) for r in auxvs],
        selectors=tuple(Expr(be, "base", r) for r in sels),
        alpha=Expr(be, "ext", alpha),
    )
    air.eval(f)
    assert f.acc is not None, "AIR produced no constraints"
    if f.acc.kind == "base":
        f.acc = Expr(be, "ext", be._ext(f.acc.val, "base"))
    lo_reg, hi_reg = f.acc.val

    # variable order: inputs | constants | X | expected | parity pad
    n_consts = len(be.const_values)
    x_order = n_inputs + n_consts
    expected_order = x_order + 1
    num_vars = expected_order + 1
    if num_vars % 2:
        num_vars += 1

    # gates: recorded SSA, then lo + hi*X, the zero pads for
    # word-alignment, and the final expected subtraction (node 0)
    n_ssa = len(be.instrs)
    n_tail = 3  # mul(hi, X), add(lo, .), sub(., expected)
    pad = (-(n_ssa + n_tail)) % 4
    num_eval = n_ssa + n_tail + pad
    total = num_vars + num_eval
    if total > ACE_MAX_ID:
        raise ValueError(f"ACE circuit too large: {total} nodes")

    def ace_id(order: int) -> int:
        return total - 1 - order

    def reg_id(reg: int) -> int:
        # interp reg order: inputs+consts stay in place; SSA instr k
        # shifts past the X/expected/pad variable slots
        if reg < be.n_fixed:
            return ace_id(reg)
        return ace_id(num_vars + (reg - be.n_fixed))

    words = []

    def gate(op: int, id_l: int, id_r: int) -> int:
        assert max(id_l, id_r) < total
        words.append(id_l | (id_r << 30) | (op << 60))
        return total - 1 - (num_vars + len(words) - 1)

    for op, a, b in be.instrs:
        gate(_OP_TO_ACE[op], reg_id(a), reg_id(b))
    hi_x = gate(ACE_MUL, reg_id(hi_reg), ace_id(x_order))
    res = gate(ACE_ADD, reg_id(lo_reg), hi_x)
    zero_src = ace_id(0)
    for _ in range(pad):
        res_keep = res
        z = gate(ACE_SUB, zero_src, zero_src)  # noqa: F841 (zero filler)
        res = res_keep
    final = gate(ACE_SUB, res, ace_id(expected_order))
    assert final == 0, "final gate must produce node 0"

    return AceCircuit(
        air_name=type(air).__name__,
        n_inputs=n_inputs,
        const_values=tuple(be.const_values),
        num_vars=num_vars,
        num_eval=num_eval,
        instr_words=tuple(words),
    )


def eval_circuit_program(circuit: AceCircuit, inputs, expected):
    """A MAST program that writes the circuit to memory and EVALCIRCUITs
    it (the execute-side harness; the AIR-side coverage is the ACE
    chiplet)."""
    from .mast import MastForest, Program
    from .ops import Op

    base = 1000  # word-aligned scratch
    felts = circuit.var_felts(inputs, expected)
    ops = []
    for i in range(0, len(felts), 4):
        word = felts[i : i + 4]
        for v in reversed(word):
            ops.append(Op("PUSH", int(v)))
        ops.append(Op("PUSH", base + i))
        ops.append(Op("MSTOREW"))
        ops.extend([Op("DROP")] * 4)
    instr_base = base + 2 * circuit.num_vars
    for k, wv in enumerate(circuit.instr_words):
        ops.append(Op("PUSH", int(wv)))
        ops.append(Op("PUSH", instr_base + k))
        ops.append(Op("MSTORE"))
        ops.append(Op("DROP"))
    ops += [
        Op("PUSH", circuit.num_eval),
        Op("PUSH", circuit.num_vars),
        Op("PUSH", base),
        Op("EVALCIRCUIT"),
        Op("DROP"),
        Op("DROP"),
        Op("DROP"),
    ]
    forest = MastForest()
    root = forest.add_block(ops)
    forest.make_root(root)
    return Program(forest, root)
