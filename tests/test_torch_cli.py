"""The port's command line (``python -m miden_tpu_torch``) ≡ ``miden_tpu``'s.

In-process ``main([...])``: ``compile`` and ``run`` print what
``miden_tpu.cli.main`` prints for the same files (timings aside), an
``advice_map`` input included; ``compile -o`` writes the same bytes;
``prove --device cpu`` then ``verify --device cpu`` accepts, ``miden_tpu``'s
``VmProof.from_bytes`` + ``verify_program`` accept the port's proof file,
and a flipped byte makes ``verify`` exit 1. Without ``--device cpu`` the
port asks for the card and, having none here, stops: there is no fallback.
"""

import json
import re

import pytest
import torch

from miden_tpu import cli as j_cli
from miden_tpu_torch import cli

FIB = "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end"
#: operand stack, advice stack and an advice-map entry read by push_mapval
ADVICE = "begin adv_push.1 add push.4.3.2.1 adv.push_mapval dropw adv_push.2 add add end"
INPUTS = {
    "operand_stack": ["5", "0x6"],
    "advice_stack": ["7"],
    "advice_map": {"".join(i.to_bytes(8, "little").hex() for i in (1, 2, 3, 4)): ["10", "20"]},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the CPU proof is small-tensor dispatch, as fast on
    one thread, and on eight it oversubscribes the cores the other workers
    use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(tmp_path, src, inputs=None):
    prog = tmp_path / "prog.masm"
    prog.write_text(src)
    args = [str(prog)]
    if inputs is not None:
        path = tmp_path / "inputs.json"
        path.write_text(json.dumps(inputs))
        args += ["-i", str(path)]
    return args


def _printed(main, argv, capsys) -> str:
    assert main(argv) == 0
    return re.sub(r"\d+\.\d+s", "<t>", capsys.readouterr().out)


@pytest.mark.parametrize("src, inputs", [(FIB, None), (ADVICE, INPUTS)], ids=["fib", "advice"])
def test_compile_and_run_print_what_miden_tpu_prints(tmp_path, capsys, src, inputs):
    args = _files(tmp_path, src, inputs)
    prog = args[:1]
    assert _printed(cli.main, ["compile", *prog], capsys) == _printed(j_cli.main, ["compile", *prog], capsys)
    mine = _printed(cli.main, ["run", *args, "--device", "cpu"], capsys)
    assert mine == _printed(j_cli.main, ["run", *args], capsys)
    if inputs is not None:
        assert "output stack: [42, 6, 0," in mine


def test_compile_output_bytes_equal_miden_tpu(tmp_path, capsys):
    args = _files(tmp_path, FIB)
    mine, theirs = tmp_path / "port.mast", tmp_path / "ref.mast"
    out = _printed(cli.main, ["compile", *args, "-o", str(mine)], capsys)
    assert out == _printed(j_cli.main, ["compile", *args, "-o", str(theirs)], capsys).replace(
        str(theirs), str(mine))
    assert mine.read_bytes() == theirs.read_bytes()


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["run", *_files(tmp_path, FIB)])


def test_prove_on_the_cpu_then_verify(tmp_path, capsys):
    from miden_tpu.vm.prove import VmProof as JVmProof
    from miden_tpu.vm.prove import verify_program as j_verify_program

    args = _files(tmp_path, FIB)
    proof = tmp_path / "proof.bin"
    printed = _printed(cli.main, ["prove", *args, "-o", str(proof), "--device", "cpu"], capsys)
    hash_line = _printed(j_cli.main, ["compile", *args[:1]], capsys)
    assert hash_line in printed and "output stack: [89, 0," in printed
    verified = _printed(cli.main, ["verify", str(proof), "--device", "cpu"], capsys)
    assert verified.startswith("proof verified in <t>") and hash_line in verified

    j_verify_program(JVmProof.from_bytes(proof.read_bytes()))

    blob = bytearray(proof.read_bytes())
    blob[8 + 32 + 32 + 16 * 8] ^= 1  # the low byte of the first stack output
    proof.write_bytes(bytes(blob))
    assert cli.main(["verify", str(proof), "--device", "cpu"]) == 1
    assert capsys.readouterr().out.startswith("VERIFICATION FAILED")
