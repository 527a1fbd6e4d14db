"""The port's MAST wire form (``miden_tpu_torch.vm.mast_io``) ≡ ``miden_tpu``'s.

The cases of ``tests/test_mast_io.py`` on the port (roundtrips, digests
recomputed on decode, malformed inputs rejected with ``MastFormatError``),
and the bytes of both packages equal: each decodes the other's wire form to
the same program hash.
"""

import struct

import pytest

from miden_tpu.vm import mast_io as j_mast_io
from miden_tpu.vm.assembler import assemble as j_assemble
from miden_tpu_torch.vm import mast_io
from miden_tpu_torch.vm.assembler import assemble
from miden_tpu_torch.vm.mast_io import (
    MAGIC,
    MastFormatError,
    forest_from_bytes,
    forest_to_bytes,
    program_from_bytes,
    program_to_bytes,
)
from miden_tpu_torch.vm.processor import execute

SRC = """
proc square
    dup mul
end
begin
    push.3 exec.square
    push.1
    if.true push.1 else push.2 end
    push.1
    while.true push.7 drop push.0 end
    drop
end
"""

PROGRAMS = {
    "control_flow": SRC,
    "fib": "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end",
    "err_and_imm": 'begin push.18446744069414584320 push.5 add assert.err="not zero" end',
    "call": "proc f\n    push.1 add\nend\nbegin\n    push.2 call.f drop\nend",
}


def test_program_roundtrip_preserves_hash_and_behavior():
    prog = assemble(SRC)
    data = program_to_bytes(prog)
    back = program_from_bytes(data)
    assert back.hash == prog.hash
    assert back.kernel_digests == prog.kernel_digests
    assert execute(back).stack == execute(prog).stack
    assert program_to_bytes(back) == data


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_wire_bytes_equal_miden_tpu_and_decode_across(name):
    src = PROGRAMS[name]
    mine, theirs = assemble(src), j_assemble(src)
    data = program_to_bytes(mine)
    assert data == j_mast_io.program_to_bytes(theirs)
    assert forest_to_bytes(mine.forest) == j_mast_io.forest_to_bytes(theirs.forest)
    assert tuple(program_from_bytes(data).hash) == tuple(j_mast_io.program_from_bytes(data).hash) == tuple(mine.hash)


def test_digests_recomputed_not_trusted():
    prog = assemble("begin push.1 push.2 add end")
    data = bytearray(program_to_bytes(prog))
    data[4 + 4 + 4 + 1 + 4] ^= 1  # the first op byte
    try:
        back = program_from_bytes(bytes(data))
    except MastFormatError:
        return
    assert back.hash != prog.hash


@pytest.mark.parametrize(
    "mutate",
    [
        lambda d: d[: len(d) // 2],
        lambda d: d + b"\x00",
        lambda d: b"XXXX" + d[4:],
        lambda d: d[:4] + struct.pack("<I", 99) + d[8:],
        lambda d: d[:8] + struct.pack("<I", 1 << 21) + d[12:],
    ],
    ids=["truncated", "trailing", "magic", "version", "node_budget"],
)
def test_malformed_inputs_rejected(mutate):
    data = program_to_bytes(assemble("begin push.1 drop end"))
    with pytest.raises(MastFormatError):
        program_from_bytes(mutate(data))
    with pytest.raises(j_mast_io.MastFormatError):
        j_mast_io.program_from_bytes(mutate(data))


def test_forward_child_reference_rejected():
    bad = MAGIC + struct.pack("<II", 1, 1) + struct.pack("<BII", 1, 0, 5) + struct.pack("<II", 0, 0)
    with pytest.raises(MastFormatError):
        forest_from_bytes(bad)


def test_oversized_input_rejected_before_parse():
    with pytest.raises(MastFormatError):
        forest_from_bytes(b"\x00" * (mast_io.MAX_BYTES + 1))


def test_a_block_over_2_16_ops_round_trips():
    """``repeat.n`` unrolls into one basic block. ``miden_tpu`` writes the
    wire form of a block over 2^16 ops and then refuses to read it back
    (pinned: this fails once ``miden_tpu`` is repaired); the port's decoder
    takes a block up to its total op budget."""
    src = "begin push.0 push.1 repeat.21846 swap dup.1 add end swap drop swap drop end"
    prog = assemble(src)
    data = program_to_bytes(prog)
    assert data == j_mast_io.program_to_bytes(j_assemble(src))
    assert program_from_bytes(data).hash == prog.hash
    with pytest.raises(j_mast_io.MastFormatError, match="basic block op budget"):
        j_mast_io.program_from_bytes(data)
