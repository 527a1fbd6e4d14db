"""The programs of chip_smoke.py's phase 10 (``miden_tpu_torch.bench_stdlib``),
rehearsed on the CPU: each leaves the host's answer on the stack, and
``miden_tpu`` executes it to the same stack and clock.
"""

from __future__ import annotations

from miden_tpu.merkle import MerkleStore as JMerkleStore
from miden_tpu.stdlib import assemble_with_stdlib as j_assemble_with_stdlib
from miden_tpu.stdlib import stdlib_event_handlers as j_handlers
from miden_tpu.vm.processor import AdviceProvider as JAdviceProvider
from miden_tpu.vm.processor import execute as j_execute
from miden_tpu_torch import bench_stdlib as B
from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
from miden_tpu_torch.vm.processor import execute


def run_both(src: str, inputs=(), advice=None, j_advice=None):
    out = execute(assemble_with_stdlib(src), list(inputs), advice=advice, event_handlers=stdlib_event_handlers())
    j_out = j_execute(j_assemble_with_stdlib(src), list(inputs), advice=j_advice, event_handlers=j_handlers())
    assert [int(v) for v in out.stack] == [int(v) for v in j_out.stack] and out.clk == j_out.clk
    return out


def test_u64_program_leaves_the_host_u64():
    assert [int(v) for v in run_both(B.U64_PROGRAM).stack[:2]] == B.u64_program_top()


def test_blake3_chain_program_at_full_size_leaves_the_host_chain():
    """stdlib-blake3-18's program: 28 hashes, 252,138 cycles (core 2^18)."""
    out = run_both(B.blake3_chain_program(), B.blake3_inputs())
    assert [int(v) for v in out.stack[:8]] == B.blake3_chain_digest()
    assert out.clk == B.BLAKE3_CYCLES == 252138


def test_host_program_leaves_the_host_values():
    src, advice, want = B.host_program()
    j_advice = JAdviceProvider(stack=list(advice.stack), map=dict(advice.map), store=JMerkleStore())
    j_advice.store.extend(advice.store.inner_nodes())
    out = run_both(src, advice=advice, j_advice=j_advice)
    assert [int(v) for v in out.stack[:16]] == want
    for module in ("mem", "word", "u128", "sorted_array", "mmr", "smt", "sha256", "poseidon2", "aead"):
        assert f"::{module}" in src.split("begin")[0]
