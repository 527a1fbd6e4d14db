"""The port's VM host layer ≡ miden_tpu's, on the CPU.

The assembler, MAST, processor, native C trace generator, chiplet trace
builders and relation seed of ``miden_tpu_torch`` are copies of the JAX
package's host modules; these tests hold them equal to ``miden_tpu`` on the
same programs: the MAST digest, the three trace matrices of
``execute_and_trace`` (native C path and Python interpreter), the
Fiat–Shamir relation seed, and the ``MVMP`` proof container's bytes. All
comparisons are exact.
"""

import numpy as np
import pytest
import torch

from miden_tpu.merkle import MerkleStore as JMerkleStore
from miden_tpu.merkle import MerkleTree as JMerkleTree
from miden_tpu.stark.proof_io import ProofFormatError as JProofFormatError
from miden_tpu.vm import AdviceProvider as JAdviceProvider
from miden_tpu.vm import assemble as j_assemble
from miden_tpu.vm.prove import VmProof as JVmProof
from miden_tpu.vm.prove import protocol_seed as j_protocol_seed
from miden_tpu.vm.trace import execute_and_trace as j_execute_and_trace
from miden_tpu_torch.merkle import MerkleStore, MerkleTree
from miden_tpu_torch.stark.proof_io import ProofFormatError
from miden_tpu_torch.stark.prover import Proof
from miden_tpu_torch.transcript.challenger import TranscriptData
from miden_tpu_torch.vm import AdviceProvider, assemble
from miden_tpu_torch.vm import native_trace
from miden_tpu_torch.vm.prove import VmProof, protocol_seed
from miden_tpu_torch.vm.trace import execute_and_trace

FIB = "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end"
U32_IF = (
    "begin push.2 push.3 u32wrapping_add push.5 mul "
    "push.1 if.true push.7 add else push.8 add end swap drop end"
)
WHILE = """
begin
    push.5 push.0 swap
    dup neq.0
    while.true
        swap dup.1 add swap
        sub.1 dup neq.0
    end
    drop swap drop
end
"""
PROCS = """
proc sq
    dup mul
end
proc reader
    push.100 mem_load swap drop
end
begin
    push.2 exec.sq exec.sq
    push.42 mem_store.100
    call.reader
    drop
end
"""
LEAVES = [(3 * i + 1, 0, i, 0) for i in range(8)]


def _mtree_program(tree_cls):
    root = ".".join(str(x) for x in reversed(tree_cls(LEAVES).root))
    return f"begin push.{root} push.5 push.3 mtree_get movupw.2 dropw movupw.2 dropw end"


def _advice(tree_cls, store_cls, advice_cls):
    store = store_cls()
    store.extend(tree_cls(LEAVES).inner_nodes())
    return advice_cls(store=store)


@pytest.mark.parametrize("source", [FIB, U32_IF, WHILE, PROCS], ids=["fib", "u32_if", "while", "procs"])
def test_mast_digest_equals_miden_tpu(source):
    mine, theirs = assemble(source), j_assemble(source)
    assert mine.forest[mine.entrypoint].digest == theirs.forest[theirs.entrypoint].digest


def test_mtree_program_digest_equals_miden_tpu():
    assert MerkleTree(LEAVES).root == JMerkleTree(LEAVES).root
    mine, theirs = assemble(_mtree_program(MerkleTree)), j_assemble(_mtree_program(JMerkleTree))
    assert mine.forest[mine.entrypoint].digest == theirs.forest[theirs.entrypoint].digest


def test_large_merkle_tree_equals_miden_tpu():
    # 2^11 leaves: the port folds the lower layers as batched compressions
    leaves = [(i, 2 * i, 3 * i, 4 * i) for i in range(1 << 11)]
    mine, theirs = MerkleTree(leaves, device="cpu"), JMerkleTree(leaves)
    assert mine.root == theirs.root
    assert list(mine.inner_nodes()) == list(theirs.inner_nodes())


def test_large_merkle_tree_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    leaves = [(i, 0, 0, 0) for i in range(1 << 10)]
    with pytest.raises((AssertionError, RuntimeError)):
        MerkleTree(leaves)
    assert MerkleTree(leaves[:512]).root == JMerkleTree(leaves[:512]).root  # below the threshold: the host


BLOCK_OPS = [("PUSH", 3), ("PUSH", 4), "ADD", ("PUSH", 7), "MUL", "U32SPLIT", "ADD", "SWAP", "DROP"]


def _block_program(forest_cls, program_cls, op_cls):
    # a program whose entry is one basic block, with no join around it
    forest = forest_cls()
    bid = forest.add_block([op_cls(n) if isinstance(n, str) else op_cls(*n) for n in BLOCK_OPS])
    forest.roots.append(bid)
    return program_cls(forest, bid)


def _traces(case):
    if case == "mtree":
        mine = execute_and_trace(
            assemble(_mtree_program(MerkleTree)),
            advice=_advice(MerkleTree, MerkleStore, AdviceProvider),
        )
        theirs = j_execute_and_trace(
            j_assemble(_mtree_program(JMerkleTree)),
            advice=_advice(JMerkleTree, JMerkleStore, JAdviceProvider),
        )
        return mine, theirs
    if case == "block":
        from miden_tpu.vm import MastForest as JForest
        from miden_tpu.vm import Op as JOp
        from miden_tpu.vm import Program as JProgram
        from miden_tpu_torch.vm import MastForest, Op, Program

        return (
            execute_and_trace(_block_program(MastForest, Program, Op)),
            j_execute_and_trace(_block_program(JForest, JProgram, JOp)),
        )
    source = {"fib": FIB, "u32_if": U32_IF, "while": WHILE}[case]
    return execute_and_trace(assemble(source)), j_execute_and_trace(j_assemble(source))


@pytest.mark.parametrize("case", ["fib", "u32_if", "while", "mtree", "block"])
def test_execute_and_trace_equals_miden_tpu(case):
    before = dict(native_trace.RUNS)
    (out, trace), (j_out, j_trace) = _traces(case)
    assert out.stack == j_out.stack
    for name in ("matrix", "chiplets", "poseidon"):
        got, want = np.asarray(getattr(trace, name)), np.asarray(getattr(j_trace, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert (got == want).all(), name
    for name in ("program_hash", "stack_inputs", "stack_outputs", "kernel_digests", "deferred_root"):
        assert tuple(getattr(trace, name)) == tuple(getattr(j_trace, name)), name
    ran = {k: native_trace.RUNS[k] - before[k] for k in before}
    # control flow runs in Python and op blocks in C; the advice program's
    # Merkle op keeps its block in the Python interpreter
    if case == "mtree":
        assert ran["rows"] < trace.num_real_rows
    else:
        assert 0 < ran["rows"] <= trace.num_real_rows


def _word(i):
    return (7 * i + 1, 11 * i, 13 * i + 5, 0)


@pytest.mark.parametrize("depth", [8, 64])
def test_simple_smt_equals_miden_tpu(depth):
    from miden_tpu.merkle import SimpleSmt as JSimpleSmt
    from miden_tpu_torch.merkle import SimpleSmt

    keys = [0, 3, 200, (1 << depth) - 1]
    mine = SimpleSmt(depth, [(k, _word(k)) for k in keys])
    theirs = JSimpleSmt(depth, [(k, _word(k)) for k in keys])
    assert mine.insert(3, _word(99)) == theirs.insert(3, _word(99))
    assert mine.root == theirs.root
    for key in keys + [5]:
        (path, leaf), (j_path, j_leaf) = mine.open(key), theirs.open(key)
        assert leaf == j_leaf and path.nodes == j_path.nodes
        assert path.verify(key, leaf, mine.root)


def test_smt_equals_miden_tpu():
    from miden_tpu.merkle import Smt as JSmt
    from miden_tpu_torch.merkle import Smt

    # two keys share leaf 9 (their last felt), so one leaf holds two entries
    entries = [((1, 2, 3, 9), _word(1)), ((4, 5, 6, 9), _word(2)), ((0, 0, 1, 1 << 40), _word(3))]
    mine, theirs = Smt(entries), JSmt(entries)
    assert mine.insert(entries[2][0], (0, 0, 0, 0)) == theirs.insert(entries[2][0], (0, 0, 0, 0))
    assert mine.root == theirs.root and mine.num_entries() == 2
    for key, value in entries[:2]:
        proof, j_proof = mine.open(key), theirs.open(key)
        assert proof.path.nodes == j_proof.path.nodes
        assert proof.leaf.hash() == j_proof.leaf.hash()
        assert proof.verify_membership(key, value, mine.root)


@pytest.mark.parametrize("num_leaves", [1, 7, 12])
def test_mmr_equals_miden_tpu(num_leaves):
    from miden_tpu.merkle import Mmr as JMmr
    from miden_tpu.merkle import PartialMmr as JPartialMmr
    from miden_tpu_torch.merkle import Mmr, PartialMmr

    leaves = [_word(i) for i in range(num_leaves)]
    mine, theirs = Mmr(leaves), JMmr(leaves)
    peaks = mine.peaks()
    assert peaks.peaks == theirs.peaks().peaks
    assert peaks.hash_peaks() == theirs.peaks().hash_peaks()
    assert list(mine.inner_nodes()) == list(theirs.inner_nodes())
    for pos in range(num_leaves):
        proof = mine.open(pos)
        assert proof.merkle_path.nodes == theirs.open(pos).merkle_path.nodes
        assert peaks.verify(leaves[pos], proof)
    # a partial MMR tracking leaf 0 keeps its path through appends
    part, j_part = PartialMmr(peaks), JPartialMmr(theirs.peaks())
    part.track(0, leaves[0], mine.open(0).merkle_path)
    j_part.track(0, leaves[0], theirs.open(0).merkle_path)
    for i in range(num_leaves, num_leaves + 5):
        part.add(_word(i), track=True)
        j_part.add(_word(i), track=True)
    assert part.peaks().peaks == j_part.peaks().peaks
    assert part.open(0).merkle_path.nodes == j_part.open(0).merkle_path.nodes


def test_merkle_store_from_mmr_equals_miden_tpu():
    from miden_tpu.merkle import Mmr as JMmr
    from miden_tpu.merkle import NodeIndex as JNodeIndex
    from miden_tpu_torch.merkle import Mmr, NodeIndex

    leaves = [_word(i) for i in range(8)]
    mine, theirs = MerkleStore(), JMerkleStore()
    mine.extend(Mmr(leaves).inner_nodes())
    theirs.extend(JMmr(leaves).inner_nodes())
    root = Mmr(leaves).peaks().peaks[0]
    assert mine.num_internal_nodes() == theirs.num_internal_nodes()
    for pos in range(8):
        node, path = mine.get_path(root, NodeIndex(3, pos))
        j_node, j_path = theirs.get_path(root, JNodeIndex(3, pos))
        assert node == j_node == leaves[pos] and path.nodes == j_path.nodes


def test_core_trace_widths_follow_the_airs():
    from miden_tpu_torch.vm.constraints import CoreVmAir
    from miden_tpu_torch.vm.constraints.chiplets_air import ChipletsVmAir
    from miden_tpu_torch.vm.constraints.poseidon2_air import Poseidon2PermutationAir

    _, trace = execute_and_trace(assemble(U32_IF))
    assert trace.matrix.shape[1] == CoreVmAir.width
    assert trace.chiplets.shape[1] == ChipletsVmAir.width
    assert trace.poseidon.shape[1] == Poseidon2PermutationAir.width


def test_protocol_seed_equals_miden_tpu():
    assert protocol_seed() == j_protocol_seed()


def _container(**kw):
    fields = dict(
        program_hash=(1, 2, 3, 4),
        stack_inputs=list(range(16)),
        stack_outputs=[(7 * i) % 11 for i in range(16)],
        kernel_digests=((5, 6, 7, 8), (9, 10, 11, 12)),
        stark=Proof(log_heights=[6, 4, 6], data=TranscriptData([1, 2, 3], [(4, 5, 6, 7)])),
        deferred_root=(13, 14, 15, 16),
        deferred_wire=b"\x01\x02\x03",
    )
    fields.update(kw)
    return VmProof(**fields)


@pytest.mark.parametrize("wire", [b"\x01\x02\x03", None])
def test_vm_proof_bytes_round_trip_and_equal_miden_tpu(wire):
    proof = _container(deferred_wire=wire)
    blob = proof.to_bytes()
    assert blob[:4] == b"MVMP"
    back = VmProof.from_bytes(blob)
    assert back.to_bytes() == blob
    assert back.program_hash == proof.program_hash
    assert back.kernel_digests == proof.kernel_digests
    assert back.deferred_root == proof.deferred_root
    assert back.deferred_wire == wire
    assert back.stark.log_heights == [6, 4, 6]
    # the JAX package parses the same bytes and writes them back unchanged
    assert JVmProof.from_bytes(blob).to_bytes() == blob


@pytest.mark.parametrize("cut", [3, 9, 40, 300])
def test_truncated_vm_proof_is_rejected(cut):
    blob = _container().to_bytes()[:cut]
    with pytest.raises(ProofFormatError):
        VmProof.from_bytes(blob)
    with pytest.raises(JProofFormatError):
        JVmProof.from_bytes(blob)


def _deferred_state(D):
    # one logged u256 add claim, as an execution's
    # event handlers would register them
    st = D.DeferredState(D.default_registry())
    a, b = 77, (1 << 250) + 13
    nodes = [D.u256_value_node(x) for x in (a, b, (a + b) % (1 << 256))]
    for node in nodes:
        st.register(node)
    stmt = st.register(D.binop_statement_node(D.PID_U256_ADD, *(n.digest() for n in nodes)))
    st.log_statement(stmt)
    return st


def test_deferred_state_wire_equals_miden_tpu():
    from miden_tpu.vm import deferred as JD
    from miden_tpu_torch.vm import deferred as D

    mine, theirs = _deferred_state(D), _deferred_state(JD)
    assert mine.root == theirs.root and any(mine.root)
    blob = mine.to_wire().to_bytes()
    assert blob == theirs.to_wire().to_bytes()
    back = D.DeferredState.from_wire(D.default_registry(), D.DeferredStateWire.from_bytes(blob))
    assert back.root == mine.root
