"""The port's ``collections::{mmr, smt, sorted_array}`` ≡ miden_tpu's.

The programs of ``tests/test_mmr_masm.py``, ``test_smt_masm.py`` and
``test_sorted_array_masm.py`` run through both packages' ``execute``, each
with advice built from its own package's host structures (``Mmr``, ``Smt`` +
``smt_advice``): the stacks must be equal, and equal to the host answers.
Forged advice must be rejected by both.
"""

from __future__ import annotations

import itertools
import random

import pytest

from miden_tpu.merkle import Mmr as JMmr
from miden_tpu.merkle.nodes import MerkleError as JMerkleError
from miden_tpu.merkle.smt import Smt as JSmt
from miden_tpu.stdlib import assemble_with_stdlib as j_assemble_with_stdlib
from miden_tpu.stdlib import smt_advice as j_smt_advice
from miden_tpu.stdlib import stdlib_event_handlers as j_handlers
from miden_tpu.vm.processor import AdviceProvider as JAdviceProvider
from miden_tpu.vm.processor import ExecutionError as JExecutionError
from miden_tpu.vm.processor import execute as j_execute
from miden_tpu_torch.merkle import Mmr
from miden_tpu_torch.merkle.nodes import MerkleError
from miden_tpu_torch.merkle.smt import Smt
from miden_tpu_torch.stdlib import assemble_with_stdlib, smt_advice, stdlib_event_handlers
from miden_tpu_torch.vm.processor import AdviceProvider, ExecutionError, execute

PORT = (Mmr, Smt, smt_advice, AdviceProvider)
JAX = (JMmr, JSmt, j_smt_advice, JAdviceProvider)


def run_both(src: str, inputs=(), advice=None) -> list[int]:
    """``advice(package)`` builds a package's advice from its own host
    structures (``package`` is PORT or JAX)."""
    out = execute(
        assemble_with_stdlib(src), list(inputs), advice=advice and advice(PORT),
        event_handlers=stdlib_event_handlers(),
    )
    j_out = j_execute(
        j_assemble_with_stdlib(src), list(inputs), advice=advice and advice(JAX),
        event_handlers=j_handlers(),
    )
    assert [int(v) for v in out.stack] == [int(v) for v in j_out.stack]
    return [int(v) for v in out.stack]


def raises_both(src: str, inputs=(), advice=None) -> None:
    with pytest.raises((ExecutionError, MerkleError)):
        execute(assemble_with_stdlib(src), list(inputs), advice=advice and advice(PORT),
                event_handlers=stdlib_event_handlers())
    with pytest.raises((JExecutionError, JMerkleError)):
        j_execute(j_assemble_with_stdlib(src), list(inputs), advice=advice and advice(JAX),
                  event_handlers=j_handlers())


# ---------------------------------------------------------------------------
# collections::mmr
# ---------------------------------------------------------------------------

MMR_PTR = 10000


def host_mmr(package, n_leaves: int):
    return package[0]([[i + 1, 2 * i, 3, i] for i in range(n_leaves)])


def mmr_advice(n_leaves: int, forged: bool = False):
    """Advice for ``mmr::unpack``: the packed peaks under the commitment
    (and, with ``forged``, under the commitment with element 0 flipped)."""

    def build(package):
        mmr = host_mmr(package, n_leaves)
        peaks = mmr.peaks()
        num = len(peaks.peaks)
        padded = 16 if num < 16 else num + (num & 1)
        flat = [mmr.forest, 0, 0, 0] + [v for p in peaks.peaks for v in p] + [0] * ((padded - num) * 4)
        adv = package[3]()
        com = tuple(peaks.hash_peaks())
        adv.map[com] = flat
        if forged:
            adv.map[(com[0] ^ 1, *com[1:])] = flat
        adv.store.extend(mmr.inner_nodes())
        return adv

    return build


def mmr_commitment(n_leaves: int) -> list[int]:
    com = host_mmr(PORT, n_leaves).peaks().hash_peaks()
    assert list(com) == list(host_mmr(JAX, n_leaves).peaks().hash_peaks())
    return list(com)


def _unpack(com) -> str:
    return (f"use miden::core::collections::mmr\nbegin push.{MMR_PTR} "
            f"push.{com[3]}.{com[2]}.{com[1]}.{com[0]} exec.mmr::unpack ")


@pytest.mark.parametrize("n_leaves", [1, 3, 7, 11])
def test_mmr_unpack_then_get_equals_miden_tpu_and_the_host(n_leaves):
    com = mmr_commitment(n_leaves)
    for pos in sorted({0, n_leaves // 2, n_leaves - 1}):
        src = _unpack(com) + f"push.{MMR_PTR} push.{pos} exec.mmr::get end"
        got = run_both(src, advice=mmr_advice(n_leaves))
        assert got[:4] == list(host_mmr(PORT, n_leaves).get(pos))


def test_mmr_get_out_of_range_rejected_by_both():
    raises_both(_unpack(mmr_commitment(3)) + f"push.{MMR_PTR} push.3 exec.mmr::get end", advice=mmr_advice(3))


@pytest.mark.parametrize("n_leaves", [1, 2, 3, 6])
def test_mmr_unpack_pack_round_trip_equals_miden_tpu(n_leaves):
    com = mmr_commitment(n_leaves)
    got = run_both(_unpack(com) + f"push.{MMR_PTR} exec.mmr::pack end", advice=mmr_advice(n_leaves))
    assert got[:4] == com


@pytest.mark.parametrize("n_leaves", [1, 2, 3, 7])
def test_mmr_add_equals_miden_tpu_and_the_host(n_leaves):
    leaf = [111, 222, 333, 444]
    host = host_mmr(PORT, n_leaves)
    host.add(leaf)
    src = (_unpack(mmr_commitment(n_leaves)) + f"push.{MMR_PTR} push.{leaf[3]}.{leaf[2]}.{leaf[1]}.{leaf[0]} "
           f"exec.mmr::add push.{MMR_PTR} exec.mmr::pack end")
    assert run_both(src, advice=mmr_advice(n_leaves))[:4] == list(host.peaks().hash_peaks())


def test_mmr_unpack_of_a_wrong_commitment_rejected_by_both():
    com = mmr_commitment(3)
    raises_both(_unpack([com[0] ^ 1, *com[1:]]) + "end", advice=mmr_advice(3, forged=True))


# ---------------------------------------------------------------------------
# collections::smt
# ---------------------------------------------------------------------------

K1 = (1, 2, 3, 40)
K2 = (9, 9, 9, 40)  # the leaf of K1: a multi-entry leaf
K3 = (5, 5, 5, 77)  # a single-entry leaf
ENTRIES = {K1: (11, 12, 13, 14), K2: (21, 22, 23, 24), K3: (31, 32, 33, 34)}
SMT_GET = "use miden::core::collections::smt\nbegin exec.smt::get end"


def host_smt(package):
    tree = package[1]()
    for key, value in ENTRIES.items():
        tree.insert(key, value)
    return tree


def smt_root() -> list[int]:
    root = list(host_smt(PORT).root)
    assert root == list(host_smt(JAX).root)
    return root


def smt_reads(keys, flip_value_limb: bool = False):
    def build(package):
        adv = package[2](host_smt(package), keys)
        if flip_value_limb:  # a forged leaf preimage: the leaf hash check must fire
            key = next(iter(adv.map))
            adv.map[key] = list(adv.map[key])
            adv.map[key][4] ^= 1
        return adv

    return build


@pytest.mark.parametrize("key,want", [
    (K1, (11, 12, 13, 14)),
    (K2, (21, 22, 23, 24)),
    (K3, (31, 32, 33, 34)),
    ((0, 0, 0, 123), (0, 0, 0, 0)),  # an empty leaf
    ((8, 8, 8, 40), (0, 0, 0, 0)),  # absent from a multi-entry leaf
    ((5, 5, 6, 77), (0, 0, 0, 0)),  # absent from a single-entry leaf
])
def test_smt_get_equals_miden_tpu_and_the_host(key, want):
    root = smt_root()
    assert host_smt(PORT).get_value(key) == want
    got = run_both(SMT_GET, list(key) + root, advice=smt_reads([key]))
    assert tuple(got[:4]) == want and got[4:8] == root


def test_smt_forged_leaf_preimage_rejected_by_both():
    raises_both(SMT_GET, list(K3) + smt_root(), advice=smt_reads([K3], flip_value_limb=True))


def test_smt_wrong_root_rejected_by_both():
    root = smt_root()
    raises_both(SMT_GET, list(K1) + [root[0] ^ 1, *root[1:]], advice=smt_reads([K1]))


# ---------------------------------------------------------------------------
# collections::sorted_array
# ---------------------------------------------------------------------------

BASE = 4000


def _stores(words, base=BASE):
    return " ".join(
        f"push.{v} push.{base + 4 * i + j} mem_store" for i, w in enumerate(words) for j, v in enumerate(w)
    )


def _sorted_src(words, body: str) -> str:
    return (f"use miden::core::collections::sorted_array\nbegin {_stores(words)} "
            f"push.{BASE + 4 * len(words)} push.{BASE} {body} end")


def _pushw(v) -> str:
    return f"push.{v[3]}.{v[2]}.{v[1]}.{v[0]}"


def _lower_bound(keys, value) -> int:
    return sum(1 for _ in itertools.takewhile(lambda k: tuple(k) < tuple(value), keys))


def test_sorted_array_find_word_equals_miden_tpu_and_bisect():
    rng = random.Random(9)
    keys = sorted({tuple(rng.randrange(50) for _ in range(4)) for _ in range(12)})
    probes = list(keys[:3]) + [keys[-1]] + [tuple(rng.randrange(50) for _ in range(4)) for _ in range(6)]
    for value in probes:
        got = run_both(_sorted_src(keys, f"{_pushw(value)} exec.sorted_array::find_word"))
        lo = _lower_bound(keys, value)
        found = int(lo < len(keys) and keys[lo] == value)
        assert got[:4] == [found, BASE + 4 * lo, BASE, BASE + 4 * len(keys)], value


def test_sorted_array_find_word_empty_range_equals_miden_tpu():
    got = run_both(_sorted_src([], f"{_pushw([1, 2, 3, 4])} exec.sorted_array::find_word"))
    assert got[:4] == [0, BASE, BASE, BASE]


def test_sorted_array_find_key_value_equals_miden_tpu_and_bisect():
    rng = random.Random(4)
    keys = sorted({tuple(rng.randrange(30) for _ in range(4)) for _ in range(8)})
    values = [[rng.randrange(100) for _ in range(4)] for _ in keys]
    words = [w for kv in zip(keys, values) for w in kv]
    probes = list(keys[:2]) + [tuple(rng.randrange(30) for _ in range(4)) for _ in range(4)]
    for value in probes:
        body = f"{_pushw(value)} exec.sorted_array::find_key_value dup.1 add.4 mem_load"
        src = _sorted_src(words, body).replace(
            f"push.{BASE + 4 * len(words)} push.{BASE}", f"push.{BASE + 8 * len(keys)} push.{BASE}")
        got = run_both(src)
        lo = _lower_bound(keys, value)
        found = int(lo < len(keys) and keys[lo] == value)
        assert got[1:3] == [found, BASE + 8 * lo]
        if found:
            assert got[0] == values[lo][0]


@pytest.mark.parametrize("proc,words", [
    ("assert_sorted_words", [[1, 0, 0, 0], [9, 0, 0, 0], [1, 2, 0, 0], [1, 2, 0, 5]]),
    ("assert_sorted_keys", [[5, 0, 0, 0], [1, 1, 1, 1], [2, 0, 0, 0], [2, 2, 2, 2]]),
], ids=["words", "keys"])
def test_sorted_array_unsorted_rejected_by_both(proc, words):
    raises_both(_sorted_src(words, f"exec.sorted_array::{proc} drop drop push.1"))


def test_sorted_array_sorted_words_accepted_by_both():
    words = [[1, 0, 0, 0], [1, 2, 0, 0], [1, 2, 0, 5], [9, 0, 0, 0]]
    assert run_both(_sorted_src(words, "exec.sorted_array::assert_sorted_words drop drop push.1"))[0] == 1


@pytest.mark.parametrize("end,start", [(BASE, BASE + 4), (BASE + 2, BASE + 1)], ids=["reversed", "unaligned"])
def test_sorted_array_bad_range_rejected_by_both(end, start):
    raises_both("use miden::core::collections::sorted_array\nbegin "
                f"push.{end} push.{start} exec.sorted_array::assert_sorted_words drop drop push.1 end")
