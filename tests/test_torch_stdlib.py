"""The port's MASM standard library ≡ miden_tpu's.

The programs of ``tests/test_stdlib.py`` (u64, the u32 clz family, procedure
locals, sys, word, mem, u128, poseidon2, debug and AEAD) run through both
packages' ``execute``: the stacks must be equal, and equal to Python
ground truth. Every stdlib procedure compiles to ``miden_tpu``'s MAST digest
(the repaired ECDSA ``verify_prehash`` excepted), and the CPU proof of
``tests/test_stdlib.py``'s u64 program at ``TEST_PARAMS`` is byte-equal to
``miden_tpu``'s, each package's verifier accepting the other's proof.
"""

from __future__ import annotations

import functools
import random

import pytest
import torch

from miden_tpu.stdlib import assemble_with_stdlib as j_assemble_with_stdlib
from miden_tpu.stdlib import stdlib_assembler as j_stdlib_assembler
from miden_tpu.stdlib import stdlib_event_handlers as j_handlers
from miden_tpu.vm.assembler import AssemblyError as JAssemblyError
from miden_tpu.vm.assembler import _CompileContext as JCompileContext
from miden_tpu.vm.assembler import assemble as j_assemble
from miden_tpu.vm.mast import MastForest as JMastForest
from miden_tpu.vm.processor import ExecutionError as JExecutionError
from miden_tpu.vm.processor import execute as j_execute
from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_assembler, stdlib_event_handlers
from miden_tpu_torch.vm.assembler import AssemblyError, _CompileContext
from miden_tpu_torch.vm.assembler import assemble
from miden_tpu_torch.vm.mast import MastForest
from miden_tpu_torch.vm.processor import ExecutionError, execute

M32 = (1 << 32) - 1
M64 = (1 << 64) - 1
M128 = (1 << 128) - 1


@functools.lru_cache(maxsize=None)
def _programs(src: str, stdlib: bool = True):
    if stdlib:
        return assemble_with_stdlib(src), j_assemble_with_stdlib(src)
    return assemble(src), j_assemble(src)


def run_both(src: str, inputs=(), stdlib: bool = True, event_handlers=None) -> list[int]:
    """Execute ``src`` on both packages (stdlib linked, its handlers
    installed); the stacks must be equal. Returns the port's stack."""
    mine, theirs = _programs(src, stdlib)
    handlers = event_handlers or (stdlib_event_handlers(), j_handlers())
    out = execute(mine, list(inputs), event_handlers=handlers[0])
    j_out = j_execute(theirs, list(inputs), event_handlers=handlers[1])
    assert [int(v) for v in out.stack] == [int(v) for v in j_out.stack]
    return [int(v) for v in out.stack]


def raises_both(src: str, inputs=(), stdlib: bool = True, event_handlers=None) -> None:
    mine, theirs = _programs(src, stdlib)
    handlers = event_handlers or (stdlib_event_handlers(), j_handlers())
    with pytest.raises(ExecutionError):
        execute(mine, list(inputs), event_handlers=handlers[0])
    with pytest.raises(JExecutionError):
        j_execute(theirs, list(inputs), event_handlers=handlers[1])


def limbs(v: int) -> list[int]:
    return [v & M32, v >> 32]


def limbs128(v: int) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(4)]


# ---------------------------------------------------------------------------
# math::u64
# ---------------------------------------------------------------------------

_rng = random.Random(7)
PAIRS = [
    (0, 0), (1, 0), (0, 1), (M64, M64), (M64, 1), (1, M64),
    (1 << 32, (1 << 32) - 1), (1 << 63, 1 << 63),
    (12345678901234567890, 987654321098765432),
] + [(_rng.getrandbits(64), _rng.getrandbits(64)) for _ in range(6)]

U64_BINARY = {
    "wrapping_add": lambda a, b: limbs((a + b) & M64),
    "overflowing_add": lambda a, b: [int(a + b > M64)] + limbs((a + b) & M64),
    "widening_add": lambda a, b: limbs((a + b) & M64) + [int(a + b > M64)],
    "wrapping_sub": lambda a, b: limbs((a - b) & M64),
    "overflowing_sub": lambda a, b: [int(a < b)] + limbs((a - b) & M64),
    "wrapping_mul": lambda a, b: limbs((a * b) & M64),
    "overflowing_mul": lambda a, b: [int(a * b > M64)] + limbs((a * b) & M64),
    "widening_mul": lambda a, b: [(a * b >> (32 * i)) & M32 for i in range(4)],
    "lt": lambda a, b: [int(a < b)],
    "gt": lambda a, b: [int(a > b)],
    "lte": lambda a, b: [int(a <= b)],
    "gte": lambda a, b: [int(a >= b)],
    "eq": lambda a, b: [int(a == b)],
    "neq": lambda a, b: [int(a != b)],
    "min": lambda a, b: limbs(min(a, b)),
    "max": lambda a, b: limbs(max(a, b)),
    "div": lambda a, b: limbs(a // b) if b else None,
    "mod": lambda a, b: limbs(a % b) if b else None,
    "divmod": lambda a, b: limbs(a % b) + limbs(a // b) if b else None,
    "and": lambda a, b: limbs(a & b),
    "or": lambda a, b: limbs(a | b),
    "xor": lambda a, b: limbs(a ^ b),
}

U64_UNARY = {
    "not": lambda a: limbs(a ^ M64),
    "eqz": lambda a: [int(a == 0)],
    "clz": lambda a: [64 - a.bit_length()],
    "ctz": lambda a: [(a & -a).bit_length() - 1 if a else 64],
    "clo": lambda a: [64 - (a ^ M64).bit_length()],
    "cto": lambda a: [((w := a ^ M64) & -w).bit_length() - 1 if a != M64 else 64],
}

U64_SHIFTS = {
    "shl": lambda a, n: limbs((a << n) & M64),
    "shr": lambda a, n: limbs(a >> n),
    "rotl": lambda a, n: limbs(((a << n) | (a >> (64 - n))) & M64 if n else a),
    "rotr": lambda a, n: limbs(((a >> n) | (a << (64 - n))) & M64 if n else a),
}


def _u64_src(proc: str) -> str:
    return f"use miden::core::math::u64\nbegin exec.u64::{proc} end"


@pytest.mark.parametrize("proc", sorted(U64_BINARY))
def test_u64_binary_equals_miden_tpu(proc):
    ref = U64_BINARY[proc]
    for a, b in PAIRS:
        want = ref(a, b)
        if want is None:
            continue
        got = run_both(_u64_src(proc), limbs(b) + limbs(a))
        assert got[: len(want)] == want, (proc, hex(a), hex(b))


@pytest.mark.parametrize("proc", sorted(U64_UNARY))
def test_u64_unary_equals_miden_tpu(proc):
    for a in (0, 1, M64, 1 << 32, (1 << 32) - 1, 0xF0F0F0F0F0F0F0F0):
        want = U64_UNARY[proc](a)
        assert run_both(_u64_src(proc), limbs(a))[: len(want)] == want, (proc, hex(a))


@pytest.mark.parametrize("proc", sorted(U64_SHIFTS))
def test_u64_shifts_equal_miden_tpu(proc):
    for a in (0, 1, M64, 1 << 63, 0x123456789ABCDEF0):
        for n in (0, 1, 31, 32, 33, 63):
            assert run_both(_u64_src(proc), [n] + limbs(a))[:2] == U64_SHIFTS[proc](a, n)


@pytest.mark.parametrize("proc", ["div", "mod", "divmod"])
def test_u64_division_by_zero_rejected_by_both(proc):
    raises_both(_u64_src(proc), limbs(0) + limbs(5))


# ---------------------------------------------------------------------------
# the u32 clz family, procedure locals, sys
# ---------------------------------------------------------------------------

U32_COUNTS = {
    "u32clz": lambda v: 32 - v.bit_length(),
    "u32ctz": lambda v: ((v & -v).bit_length() - 1) if v else 32,
    "u32clo": lambda v: 32 - ((~v) & M32).bit_length(),
    "u32cto": lambda v: (((w := (~v) & M32) & -w).bit_length() - 1 if v != M32 else 32),
}


@pytest.mark.parametrize("instr", sorted(U32_COUNTS))
def test_u32_clz_family_equals_miden_tpu(instr):
    for v in (0, 1, 2, 3, 1 << 31, M32, 0x00F0F000, 0x7FFFFFFE):
        got = run_both(f"begin push.{v} {instr} end", stdlib=False, event_handlers=({}, {}))
        assert got[0] == U32_COUNTS[instr](v), (instr, v)


def test_u32_clz_lying_advice_rejected_by_both():
    from miden_tpu.vm.events import SYSTEM_EVENT_IDS as J_IDS
    from miden_tpu_torch.vm.events import SYSTEM_EVENT_IDS

    def lying(processor):
        processor.advice.stack.insert(0, 3)  # clz(2^31) is 0, not 3

    raises_both(
        "begin push.2147483648 u32clz end", stdlib=False,
        event_handlers=({SYSTEM_EVENT_IDS["sys::u32_clz"]: lying}, {J_IDS["sys::u32_clz"]: lying}),
    )


LOCALS = {
    "store_load": ("""
        @locals(6)
        proc scratch
            loc_store.0
            loc_store.5
            loc_load.0 loc_load.5 add
            locaddr.0 locaddr.5 swap sub
        end
        begin push.7 push.35 exec.scratch swap end
        """, [42, 5]),
    "word_locals": ("""
        @locals(8)
        proc wordy
            loc_storew_le.0 dropw
            loc_storew_le.4 dropw
            padw loc_loadw_le.0
            padw loc_loadw_le.4
        end
        begin
            push.1 push.2 push.3 push.4
            push.5 push.6 push.7 push.8
            exec.wordy
        end
        """, [4, 3, 2, 1, 8, 7, 6, 5]),
    "nested_frames": ("""
        @locals(1)
        proc inner
            loc_store.0
            loc_load.0 loc_load.0 mul
        end
        @locals(2)
        proc outer
            loc_store.0 loc_store.1
            loc_load.0 exec.inner
            loc_load.1 exec.inner
            add
        end
        begin push.3 push.4 exec.outer end
        """, [25]),
    "called_context": ("""
        @locals(2)
        proc helper
            loc_store.0 loc_store.1
            loc_load.0 loc_load.1 add
        end
        proc callee
            exec.helper swap drop swap drop swap drop
        end
        begin push.10 push.32 call.callee end
        """, [42]),
}


@pytest.mark.parametrize("name", sorted(LOCALS))
def test_procedure_locals_equal_miden_tpu(name):
    src, want = LOCALS[name]
    got = run_both(src, stdlib=False, event_handlers=({}, {}))
    assert got[: len(want)] == want


def test_local_out_of_range_rejected_by_both():
    src = "@locals(2)\nproc p\n    loc_load.2\nend\nbegin exec.p end"
    with pytest.raises(AssemblyError):
        assemble(src)
    with pytest.raises(JAssemblyError):
        j_assemble(src)


@pytest.mark.parametrize("src,want", [
    ("use miden::core::sys\nbegin push.101 push.102 push.103 push.104 push.105 push.106 "
     "exec.sys::truncate_stack end", [106, 105, 104, 103, 102, 101]),
    ("use miden::core::sys\nbegin push.5 push.6 exec.sys::drop_stack_top end", [0] * 16),
], ids=["truncate_stack", "drop_stack_top"])
def test_sys_equals_miden_tpu(src, want):
    assert run_both(src)[: len(want)] == want


# ---------------------------------------------------------------------------
# word, mem
# ---------------------------------------------------------------------------

WORDS = [
    ((0, 0, 0, 0), (0, 0, 0, 0)),
    ((1, 2, 3, 4), (1, 2, 3, 4)),
    ((1, 2, 3, 4), (1, 2, 3, 5)),
    ((5, 2, 3, 4), (1, 2, 3, 4)),
    ((9, 9, 9, 1), (1, 1, 1, 2)),
    ((M64 - 1, 0, 0, 0), (0, M64 - 1, 0, 0)),
    ((7, 7, 7, 7), (7, 7, 7, 8)),
]


def _word_src(proc: str) -> str:
    return f"use miden::core::word\nbegin exec.word::{proc} end"


@pytest.mark.parametrize("rhs,lhs", WORDS)
def test_word_comparisons_equal_miden_tpu(rhs, lhs):
    key_l, key_r = tuple(reversed(lhs)), tuple(reversed(rhs))  # element 3 most significant
    for proc, want in (
        ("gt", key_l > key_r), ("gte", key_l >= key_r), ("lt", key_l < key_r),
        ("lte", key_l <= key_r), ("eq", lhs == rhs),
    ):
        assert run_both(_word_src(proc), list(rhs) + list(lhs))[0] == int(want), (proc, rhs, lhs)


def test_word_test_eq_eqz_testz_reverse_equal_miden_tpu():
    got = run_both(_word_src("test_eq"), [1, 2, 3, 4, 1, 2, 3, 4])
    assert got[0] == 1 and got[1:9] == [1, 2, 3, 4, 1, 2, 3, 4]
    assert run_both(_word_src("test_eq"), [9, 2, 3, 4, 1, 2, 3, 4])[0] == 0
    assert run_both(_word_src("eqz"), [0, 0, 0, 0])[0] == 1
    assert run_both(_word_src("eqz"), [0, 0, 1, 0])[0] == 0
    assert run_both(_word_src("testz"), [0, 0, 0, 0])[:5] == [1, 0, 0, 0, 0]
    assert run_both(_word_src("reverse"), [1, 2, 3, 4])[:4] == [4, 3, 2, 1]


def test_word_store_u32s_le_equals_miden_tpu():
    src = (
        "use miden::core::word\n"
        "begin push.100 movdn.4 exec.word::store_word_u32s_le "
        "push.100 mem_load push.101 mem_load push.104 mem_load push.107 mem_load end"
    )
    a, b, c, d = (5 << 32) | 7, 11, 1 << 63, M64 - (1 << 32)
    got = run_both(src, [a, b, c, d])
    assert got[:4] == [d >> 32, c & M32, a >> 32, a & M32]


def test_mem_memcopy_equals_miden_tpu():
    src = (
        "use miden::core::mem\n"
        "begin "
        "push.1.2.3.4 push.1000 mem_storew_le dropw "
        "push.5.6.7.8 push.1004 mem_storew_le dropw "
        "push.2000 push.1000 push.2 exec.mem::memcopy_words "
        "push.2000 mem_load push.2005 mem_load "
        "push.3000 push.1000 push.3 exec.mem::memcopy_elements "
        "push.3002 mem_load "
        "end"
    )
    assert run_both(src)[:3] == [2, 7, 4]


def test_mem_memcopy_overlap_rejected_by_both():
    raises_both("use miden::core::mem\nbegin push.1002 push.1000 push.2 exec.mem::memcopy_words end")


# ---------------------------------------------------------------------------
# math::u128
# ---------------------------------------------------------------------------

U128_PAIRS = [
    (0, 0), (1, 0), (0, 1), (M128, M128), (M128, 1), (1, M128),
    (1 << 64, (1 << 64) - 1), (1 << 127, 1 << 127),
    (0xDEADBEEF_CAFEBABE_12345678_9ABCDEF0, 0x0F1E2D3C_4B5A6978_87A9CBED_FEDCBA98),
    ((1 << 96) - 1, (1 << 32) + 5),
]


def run_u128(proc: str, b: int, a: int | None = None) -> list[int]:
    inputs = limbs128(b) if a is None else limbs128(b) + limbs128(a)
    return run_both(f"use miden::core::math::u128\nbegin exec.u128::{proc} end", inputs)


@pytest.mark.parametrize("b,a", U128_PAIRS)
def test_u128_arithmetic_equals_miden_tpu(b, a):
    total, diff = a + b, a - b
    assert run_u128("overflowing_add", b, a)[:5] == [total >> 128] + limbs128(total & M128)
    assert run_u128("wrapping_add", b, a)[:4] == limbs128(total & M128)
    assert run_u128("widening_add", b, a)[:5] == limbs128(total & M128) + [total >> 128]
    assert run_u128("overflowing_sub", b, a)[:5] == [int(diff < 0)] + limbs128(diff & M128)
    assert run_u128("wrapping_sub", b, a)[:4] == limbs128(diff & M128)
    assert run_u128("wrapping_mul", b, a)[:4] == limbs128((a * b) & M128)


@pytest.mark.parametrize("b,a", U128_PAIRS)
def test_u128_comparisons_and_bitwise_equal_miden_tpu(b, a):
    for proc, want in (
        ("eq", a == b), ("neq", a != b), ("lt", a < b), ("gt", a > b), ("lte", a <= b), ("gte", a >= b),
    ):
        assert run_u128(proc, b, a)[0] == int(want), proc
    assert run_u128("min", b, a)[:4] == limbs128(min(a, b))
    assert run_u128("max", b, a)[:4] == limbs128(max(a, b))
    for proc, want in (("and", a & b), ("or", a | b), ("xor", a ^ b)):
        assert run_u128(proc, b, a)[:4] == limbs128(want), proc
    assert run_u128("not", a)[:4] == limbs128(a ^ M128)
    assert run_u128("eqz", a)[0] == int(a == 0)


# ---------------------------------------------------------------------------
# crypto::hashes::poseidon2, debug, crypto::aead
# ---------------------------------------------------------------------------


def test_poseidon2_module_equals_miden_tpu_and_the_host():
    from miden_tpu_torch.hash import poseidon2_host as hp

    def run(proc, inputs):
        return run_both(f"use miden::core::crypto::hashes::poseidon2\nbegin exec.poseidon2::{proc} end", inputs)

    a, b = [5, 6, 7, 8], [9, 10, 11, 12]
    assert run("hash", a)[:4] == list(hp.hash_elements_padded(a))
    assert run("merge", a + b)[:4] == list(hp.merge(a, b))
    assert run("merge_in_domain", [7, *a, *b])[:4] == list(hp.merge_in_domain(a, b, 7))
    state = list(range(1, 13))
    assert run("permute", state)[:12] == list(hp.permute(state))
    assert run("init_no_padding", [42])[:13] == [0] * 12 + [42]
    assert run("squeeze_digest", state)[:4] == [1, 2, 3, 4]


def test_debug_prints_equal_miden_tpu(capfd):
    src = (
        "use miden::core::debug\n"
        "begin "
        "push.7.8.9.10 push.48 mem_storew_le dropw "
        "exec.debug::print_stack "
        "push.56.48 exec.debug::print_mem "
        "exec.debug::print_mem_all "
        "push.0 exec.debug::print_adv_stack "
        "push.42 "
        "end"
    )
    mine, theirs = _programs(src)
    out = execute(mine, [], event_handlers=stdlib_event_handlers())
    err = capfd.readouterr().err
    j_out = j_execute(theirs, [], event_handlers=j_handlers())
    j_err = capfd.readouterr().err
    assert out.stack[0] == j_out.stack[0] == 42
    assert err == j_err
    assert "[debug] stack" in err and "mem[48..52] = [10, 9, 8, 7]" in err and "advice stack" in err


def _store_elems(vals, base):
    return " ".join(
        f"push.{vals[w + 3]}.{vals[w + 2]}.{vals[w + 1]}.{vals[w]} push.{base + w} mem_storew_le dropw"
        for w in range(0, len(vals), 4)
    )


def _pushw(vals):
    return f"push.{vals[3]}.{vals[2]}.{vals[1]}.{vals[0]}"


def aead_sources(key, nonce, padded, ciphertext, tag) -> tuple[str, str]:
    """``aead::encrypt`` of ``padded`` (memory 200 → 300) and ``aead::decrypt``
    of ``ciphertext`` under ``tag`` (memory 400 → 500)."""
    n_blocks = len(padded) // 8
    enc = (
        "use miden::core::crypto::aead\nbegin " + _store_elems(padded, 200)
        + f" push.{n_blocks} push.300 push.200 {_pushw(nonce)} {_pushw(key)} exec.aead::encrypt end"
    )
    dec = (
        "use miden::core::crypto::aead\nbegin " + _store_elems(ciphertext, 400)
        + f" push.{n_blocks} push.500 push.400 {_pushw(tag)} {_pushw(nonce)} {_pushw(key)}"
        " exec.aead::decrypt end"
    )
    return enc, dec


def test_aead_encrypt_decrypt_equal_miden_tpu_and_the_host():
    from miden_tpu_torch.crypto.aead import AeadPoseidon2, _pad

    key, nonce = [11, 22, 33, 44], [55, 66, 77, 88]
    data = [101, 202, 303, 404, 505, 606, 707, 808, 909, 1010]  # 2 blocks
    enc = AeadPoseidon2(key).encrypt_elements(data, nonce=tuple(nonce))
    padded = _pad(data)
    ct, tag = [int(v) for v in enc.ciphertext], [int(v) for v in enc.auth_tag]
    src_enc, src_dec = aead_sources(key, nonce, padded, ct, tag)
    for src, base, want, top in ((src_enc, 300, ct, tag), (src_dec, 500, padded, None)):
        mine, theirs = _programs(src)
        out = execute(mine, [], event_handlers=stdlib_event_handlers())
        j_out = j_execute(theirs, [], event_handlers=j_handlers())
        assert out.stack == j_out.stack and out.memory == j_out.memory
        got = [int(v) for w in range(0, len(padded), 4) for v in out.memory[(0, base + w)]]
        assert got == want
        if top is not None:
            assert [int(v) for v in out.stack[:4]] == top
    bad_tag = [tag[0] ^ 1, *tag[1:]]
    raises_both(src_dec.replace(_pushw(tag), _pushw(bad_tag), 1))


# ---------------------------------------------------------------------------
# MAST digests of every procedure
# ---------------------------------------------------------------------------

#: the procedures whose digests differ from miden_tpu's: the repaired
#: verify_prehash (its r + n takes the carry and the comparison with p)
REPAIRED = {("miden::core::crypto::dsa::ecdsa_secp256k1", "verify_prehash")}


def _proc_digests(assembler, context_cls, forest_cls, module: str) -> dict:
    mod = assembler.modules[module]
    ctx = context_cls(assembler, forest_cls())
    return {name: ctx.forest[ctx.compile_proc(mod, name)].digest for name in mod.procs}


@functools.lru_cache(maxsize=1)
def _assemblers():
    return stdlib_assembler(), j_stdlib_assembler()


def _module_names():
    from miden_tpu_torch.stdlib import stdlib_modules

    return sorted(stdlib_modules())


@pytest.mark.parametrize("module", _module_names())
def test_every_procedure_digest_equals_miden_tpu(module):
    mine, theirs = _assemblers()
    got = _proc_digests(mine, _CompileContext, MastForest, module)
    want = _proc_digests(theirs, JCompileContext, JMastForest, module)
    assert sorted(got) == sorted(want) and got
    differ = {(module, name) for name in got if got[name] != want[name]}
    assert differ == {key for key in REPAIRED if key[0] == module}


# ---------------------------------------------------------------------------
# the u64 program's proof at TEST_PARAMS
# ---------------------------------------------------------------------------

U64_PROGRAM = """
use miden::core::math::u64
use miden::core::sys
begin
    push.0xCAFE push.0xDEADBEEF
    push.0x9ABC push.0x12345678
    exec.u64::wrapping_mul
    push.0 push.12345
    exec.u64::wrapping_add
    push.0 push.1000003
    exec.u64::divmod
    exec.u64::wrapping_add
    exec.sys::truncate_stack
end
"""


def u64_program_expected() -> int:
    a = (0xCAFE << 32) | 0xDEADBEEF
    b = (0x9ABC << 32) | 0x12345678
    q, r = divmod(((a * b) & M64) + 12345, 1000003)
    return (q + r) & M64


@pytest.fixture(scope="module")
def u64_proofs():
    """The u64 program proved by both packages on the CPU, torch at one
    thread (the suite's other workers share the cores)."""
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.vm.prove import prove_program as j_prove_program
    from miden_tpu_torch.stark import TEST_PARAMS
    from miden_tpu_torch.vm.prove import prove_program

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, proof = prove_program(
            assemble_with_stdlib(U64_PROGRAM), params=TEST_PARAMS,
            event_handlers=stdlib_event_handlers(), device="cpu",
        )
    finally:
        torch.set_num_threads(threads)
    _, j_proof = j_prove_program(
        j_assemble_with_stdlib(U64_PROGRAM), params=J_TEST_PARAMS, event_handlers=j_handlers()
    )
    return out, proof, j_proof


def test_u64_program_proof_bytes_equal_miden_tpu(u64_proofs):
    out, proof, j_proof = u64_proofs
    want = u64_program_expected()
    assert [int(v) for v in out.stack[:2]] == limbs(want)
    assert proof.to_bytes() == j_proof.to_bytes()


def test_each_verifier_accepts_the_other_packages_u64_proof(u64_proofs):
    from miden_tpu.stark.params import TEST_PARAMS as J_TEST_PARAMS
    from miden_tpu.vm.prove import VmProof as JVmProof
    from miden_tpu.vm.prove import verify_program as j_verify_program
    from miden_tpu_torch.stark import TEST_PARAMS
    from miden_tpu_torch.vm.prove import VmProof, verify_program

    _, proof, j_proof = u64_proofs
    verify_program(VmProof.from_bytes(j_proof.to_bytes()), params=TEST_PARAMS)
    j_verify_program(JVmProof.from_bytes(proof.to_bytes()), params=J_TEST_PARAMS)
