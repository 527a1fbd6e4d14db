"""Standard-library workloads: the programs of ``chip_smoke.py``'s phase 10.

Shared by ``chip_smoke.py`` and ``tests/test_torch_bench_stdlib.py`` so each
program and its expected outputs live in one place.

- :data:`U64_PROGRAM` (stdlib-small): ``tests/test_stdlib.py``'s u64 program
  (``u64::wrapping_mul``, ``wrapping_add``, ``divmod`` through the
  ``u64_div`` handler, ``sys::truncate_stack``); :func:`u64_program_top`
  is what it leaves on top of the stack.
- :func:`blake3_chain_program` (stdlib-blake3-18 at ``reps = 28``): the
  reference's blake3_1to1 benchmark program
  (masm-examples/hashing/blake3_1to1/), ``reps`` applications of
  ``blake3::hash_1to1`` to the 32-byte :data:`BLAKE3_MESSAGE` given as eight
  u32 stack inputs (:func:`blake3_inputs`); :func:`blake3_chain_digest`
  is the host's answer.
- :func:`host_program` (stdlib-host): one program through ``mem``,
  ``word``, ``u128``, ``sorted_array``, ``mmr``, ``smt``, ``sha256``,
  ``poseidon2`` and an ``aead`` round trip, each result asserted in the VM
  against the host's value, with the outputs it leaves on the stack and
  the advice (MMR peaks and nodes, SMT paths and leaves) it reads.
"""

from __future__ import annotations

import hashlib

from .crypto.aead import AeadPoseidon2, _pad
from .field import gl
from .hash import poseidon2_host as hp
from .hash.blake3_host import blake3
from .merkle import Mmr
from .merkle.smt import Smt
from .stdlib import smt_advice
from .vm.processor import AdviceProvider

M32 = (1 << 32) - 1
M64 = (1 << 64) - 1
M128 = (1 << 128) - 1

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


def u64_program_top() -> list[int]:
    """The u64 result's [lo, hi] limbs on top of U64_PROGRAM's stack."""
    a = (0xCAFE << 32) | 0xDEADBEEF
    b = (0x9ABC << 32) | 0x12345678
    q, r = divmod(((a * b) & M64) + 12345, 1000003)
    v = (q + r) & M64
    return [v & M32, v >> 32]


#: the words 0x03020100 + 0x04040404·i, i = 0..7, as bytes
BLAKE3_MESSAGE = bytes(range(32))
BLAKE3_REPS = 28
#: what BLAKE3_REPS hashes take: cycles, and the log heights of the core,
#: chiplets and Poseidon2 traces
BLAKE3_CYCLES = 252138
BLAKE3_LOG_HEIGHTS = [18, 18, 13]


def blake3_chain_program(reps: int = BLAKE3_REPS) -> str:
    return (
        "use miden::core::crypto::hashes::blake3\nuse miden::core::sys\n"
        f"begin repeat.{reps} exec.blake3::hash_1to1 end exec.sys::truncate_stack end"
    )


def _words_le(data: bytes) -> list[int]:
    return [int.from_bytes(data[4 * i : 4 * i + 4], "little") for i in range(len(data) // 4)]


def _words_be(data: bytes) -> list[int]:
    return [int.from_bytes(data[4 * i : 4 * i + 4], "big") for i in range(len(data) // 4)]


def blake3_inputs() -> list[int]:
    """The stack inputs of :func:`blake3_chain_program`: m0 on top."""
    return _words_le(BLAKE3_MESSAGE)


def blake3_chain_digest(reps: int = BLAKE3_REPS) -> list[int]:
    """The eight u32 words BLAKE3 applied ``reps`` times leaves on top."""
    data = BLAKE3_MESSAGE
    for _ in range(reps):
        data = blake3(data)
    return _words_le(data)


# ---------------------------------------------------------------------------
# stdlib-host
# ---------------------------------------------------------------------------

MMR_PTR = 10000
SORTED_PTR = 4000


def _push(values) -> str:
    """Pushes ``values`` so that values[0] ends on top."""
    return " ".join(f"push.{v}" for v in reversed(list(values)))


def _expect(values) -> str:
    """Pops the top len(values) elements, asserting each equals values[i]."""
    return " ".join(f"push.{v} assert_eq" for v in values)


def _storew(word, addr: int) -> str:
    return f"{_push(word)} push.{addr} mem_storew_le dropw"


def _limbs128(v: int) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(4)]


def host_program() -> tuple[str, AdviceProvider, list[int]]:
    """(source, advice, the 16 stack outputs). Each of the segments asserts
    its result in the VM against the host's value (so the proof attests it);
    the stack ends as [sha256::hash_2to1 of a 64-byte message (8),
    poseidon2::hash_words of the decrypted plaintext (4), the aead tag (4)]."""
    parts = ["begin"]

    # mem::memcopy_words, then word::eq of each copied word with its source
    w0, w1 = [11, 12, 13, 14], [M64 - 5, 1 << 40, 7, 0]
    parts += [_storew(w0, 1000), _storew(w1, 1004),
              "push.2000 push.1000 push.2 exec.mem::memcopy_words"]
    for off in (0, 4):
        parts.append(f"padw push.{1000 + off} mem_loadw_le padw push.{2000 + off} mem_loadw_le "
                     "exec.word::eq assert")

    # u128::overflowing_add
    a, b = 0xDEADBEEF_CAFEBABE_12345678_9ABCDEF0, 0xFFFFFFFF_0F1E2D3C_4B5A6978_87A9CBED
    total = a + b
    parts += [_push(_limbs128(b) + _limbs128(a)), "exec.u128::overflowing_add",
              _expect([total >> 128] + _limbs128(total & M128))]

    # sorted_array::find_word over six sorted words: a hit
    keys = sorted((3 * i + 1, i, 7, i * i) for i in range(6))
    probe = keys[4]
    parts += [_storew(k, SORTED_PTR + 4 * i) for i, k in enumerate(keys)]
    end = SORTED_PTR + 4 * len(keys)
    parts += [f"push.{end} push.{SORTED_PTR} {_push(probe)} exec.sorted_array::find_word",
              _expect([1, SORTED_PTR + 16, SORTED_PTR, end])]

    # mmr::unpack + mmr::get of leaf 5 of 11
    mmr = Mmr([[i + 1, 2 * i, 3, i] for i in range(11)])
    peaks = mmr.peaks()
    com = list(peaks.hash_peaks())
    num = len(peaks.peaks)
    padded = 16 if num < 16 else num + (num & 1)
    advice = AdviceProvider()
    advice.map[tuple(com)] = [mmr.forest, 0, 0, 0] + [v for p in peaks.peaks for v in p] + [0] * (
        (padded - num) * 4)
    advice.store.extend(mmr.inner_nodes())
    parts += [f"push.{MMR_PTR} {_push(com)} exec.mmr::unpack",
              f"push.{MMR_PTR} push.5 exec.mmr::get", _expect(mmr.get(5))]

    # smt::get of a key in a two-entry leaf
    smt = Smt()
    entries = {(1, 2, 3, 40): (11, 12, 13, 14), (9, 9, 9, 40): (21, 22, 23, 24), (5, 5, 5, 77): (31, 32, 33, 34)}
    for k, v in entries.items():
        smt.insert(k, v)
    read = (9, 9, 9, 40)
    smt_advice(smt, [read], advice)
    parts += [f"{_push(smt.root)} {_push(read)} exec.smt::get", _expect(list(entries[read]) + list(smt.root))]

    # aead::encrypt (200 -> 300) asserting the tag, then aead::decrypt
    # (300 -> 500) and poseidon2::hash_words over the plaintext
    key, nonce = [101, 202, 303, 404], [5, 6, 7, 8]
    data = [(i * 0x9E3779B97F4A7C15) % gl.P for i in range(13)]
    plain = _pad(data)
    n_blocks = len(plain) // 8
    enc = AeadPoseidon2(key).encrypt_elements(data, nonce=tuple(nonce))
    tag = [int(v) for v in enc.auth_tag]
    parts += [_storew(plain[i : i + 4], 200 + i) for i in range(0, len(plain), 4)]
    parts += [f"push.{n_blocks} push.300 push.200 {_push(nonce)} {_push(key)} exec.aead::encrypt",
              f"dupw {_expect(tag)}",
              f"push.{n_blocks} push.500 push.300 {_push(tag)} {_push(nonce)} {_push(key)} exec.aead::decrypt",
              f"push.{500 + len(plain)} push.500 exec.poseidon2::hash_words"]
    # => [DIGEST, TAG]; sha256::hash_2to1 on top of both
    message = bytes((7 * i + 3) % 256 for i in range(64))
    sha = _words_be(hashlib.sha256(message).digest())
    parts += [f"{_push(_words_be(message))} exec.sha256::hash_2to1", "exec.sys::truncate_stack", "end"]
    digest = list(hp.hash_elements_padded(plain))
    uses = ("mem", "word", "math::u128", "collections::sorted_array", "collections::mmr", "collections::smt",
            "crypto::hashes::sha256", "crypto::hashes::poseidon2", "crypto::aead", "sys")
    src = "\n".join(f"use miden::core::{m}" for m in uses) + "\n" + "\n".join(p for p in parts if p)
    return src, advice, sha + digest + tag
