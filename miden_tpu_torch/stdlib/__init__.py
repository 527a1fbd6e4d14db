"""MASM standard library.

A copy of ``miden_tpu``'s stdlib (the reference's crates/lib/core/asm/):
every module, the in-VM STARK verifier's (``stark/*``, ``pcs/fri/frie2f4``
and ``sys/vm/constraints_eval``, driven by ``recursion.py``'s fixtures)
included, with the same module paths, procedure names and bodies, so each
procedure's MAST digest equals ``miden_tpu``'s (the repaired ECDSA
``verify_prehash`` excepted). Modules load
from ``asm/`` next to this file and are addressed the way the reference
addresses them, e.g.::

    use miden::core::math::u64
    begin ... exec.u64::wrapping_add ... end

Host-side event handlers that stdlib procedures rely on (the u64 division
hint, crates/lib/core/src/handlers/u64_div.rs; keccak merge and hash_memory;
secp256k1 add and mul; the ECDSA commitment; AEAD decryption; the debug
prints) are provided by :func:`stdlib_event_handlers`, and the advice of
``collections::smt`` reads by :func:`smt_advice`.
"""

from __future__ import annotations

from pathlib import Path

from ..vm.assembler import Assembler
from ..vm.events import event_id
from ..vm.processor import ExecutionError

_ASM_DIR = Path(__file__).parent / "asm"
_NAMESPACE = "miden::core"

U32_MAX = 0xFFFFFFFF


def stdlib_modules() -> dict[str, str]:
    """Map of module path (``miden::core::math::u64``) -> MASM source."""
    modules: dict[str, str] = {}
    for path in sorted(_ASM_DIR.rglob("*.masm")):
        rel = path.relative_to(_ASM_DIR).with_suffix("")
        name = "::".join((_NAMESPACE, *rel.parts))
        modules[name] = path.read_text()
    return modules


def stdlib_assembler(**kwargs) -> Assembler:
    """An :class:`Assembler` with every stdlib module registered."""
    asm = Assembler(**kwargs)
    asm.add_library(stdlib_modules())
    return asm


def assemble_with_stdlib(source: str, **kwargs):
    """One-shot helper mirroring ``assemble`` with the stdlib linked."""
    return stdlib_assembler(**kwargs).assemble_program(source)


# ---------------------------------------------------------------------------
# Host event handlers
# ---------------------------------------------------------------------------


def _limbs(processor, lo_pos: int, hi_pos: int, what: str) -> int:
    lo, hi = processor.stack[lo_pos], processor.stack[hi_pos]
    if lo > U32_MAX or hi > U32_MAX:
        raise ExecutionError(f"u64_div: {what} limbs are not u32s")
    return (hi << 32) | lo


def handle_u64_div(processor) -> None:
    """``miden::core::math::u64::u64_div``: push quotient and remainder of
    a/b onto the advice stack (q_hi first, so ``adv_push.2`` leaves
    [q_lo, q_hi] on the operand stack). Reference semantics:
    crates/lib/core/src/handlers/u64_div.rs."""
    b = _limbs(processor, 1, 2, "divisor")
    a = _limbs(processor, 3, 4, "dividend")
    if b == 0:
        raise ExecutionError("u64_div: division by zero")
    q, r = divmod(a, b)
    processor.advice.stack[0:0] = [q >> 32, q & U32_MAX, r >> 32, r & U32_MAX]


def handle_keccak_merge(processor) -> None:
    """``miden::core::crypto::hashes::keccak256::merge``: read the two
    256-bit operands (8 LE u32 limbs each, limb 0 nearest the top, below
    the event id) and push the keccak256 digest limbs onto the advice
    stack (d7 first, so ``adv_push.8`` leaves [d0, ..., d7]). Reference
    analog: the keccak precompile host handler behind
    crates/lib/core/asm/crypto/hashes/keccak256.masm."""
    from ..hash.keccak_host import keccak256

    s = processor.stack
    limbs_l = [int(s[1 + i]) for i in range(8)]
    limbs_r = [int(s[9 + i]) for i in range(8)]
    for v in (*limbs_l, *limbs_r):
        if v > U32_MAX:
            raise ExecutionError("keccak256::merge: operand limb not u32")
    a = sum(v << (32 * i) for i, v in enumerate(limbs_l))
    b = sum(v << (32 * i) for i, v in enumerate(limbs_r))
    msg = a.to_bytes(32, "little") + b.to_bytes(32, "little")
    out = int.from_bytes(keccak256(msg), "little")
    dlimbs = [(out >> (32 * i)) & U32_MAX for i in range(8)]
    processor.advice.stack[0:0] = list(reversed(dlimbs))
    # register the claim in the deferred DAG so the masm's LOGDEFERRED
    # advances it through log_verified_statement (vm/deferred.py)
    from ..vm.deferred import (
        PID_KECCAK_MERGE,
        binop_statement_node,
        u256_value_node,
    )

    nodes = [u256_value_node(x) for x in (a, b, out)]
    for node in nodes:
        _register(processor, node)
    _register(
        processor,
        binop_statement_node(
            PID_KECCAK_MERGE, *(n.digest() for n in nodes)
        ),
    )


def _register(processor, node) -> None:
    """deferred.register with rejected claims surfaced as ExecutionError —
    DeferredError is a bare ValueError subclass, and callers of the event
    handlers catch ExecutionError."""
    from ..vm.deferred import DeferredError

    try:
        processor.deferred.register(node)
    except DeferredError as exc:
        raise ExecutionError(f"deferred claim rejected: {exc}") from exc


def _read_u256_limbs(processor, base: int, what: str) -> int:
    limbs = [int(processor.stack[base + i]) for i in range(8)]
    for v in limbs:
        if v > U32_MAX:
            raise ExecutionError(f"secp256k1: {what} limb not u32")
    return sum(v << (32 * i) for i, v in enumerate(limbs))


def _push_point_advice(processor, pt) -> None:
    limbs = [(pt[0] >> (32 * i)) & U32_MAX for i in range(8)]
    limbs += [(pt[1] >> (32 * i)) & U32_MAX for i in range(8)]
    processor.advice.stack[0:0] = list(reversed(limbs))


def _register_ec_claim(processor, pid, a_node, b_pt, out_pt) -> None:
    from ..vm.deferred import binop_statement_node, ec_point_node

    nodes = [a_node, ec_point_node(*b_pt), ec_point_node(*out_pt)]
    for node in nodes:
        _register(processor, node)
    _register(
        processor,
        binop_statement_node(pid, *(n.digest() for n in nodes)),
    )


def handle_secp256k1_add(processor) -> None:
    """``miden::core::crypto::ec::secp256k1::add``: read two affine
    points (8 LE u32 limbs per coordinate, xa limb 0 nearest the top,
    below the event id), push R = A + B (complete group law, (0, 0) =
    infinity) onto the advice stack, and register the EC add claim in
    the deferred DAG. Reference analog: the EC precompile host ops
    behind precompiles-prover/src/ec/add/."""
    from ..vm.deferred import PID_EC_ADD, ec_point_node, secp256k1_complete_add

    xa = _read_u256_limbs(processor, 1, "xa")
    ya = _read_u256_limbs(processor, 9, "ya")
    xb = _read_u256_limbs(processor, 17, "xb")
    yb = _read_u256_limbs(processor, 25, "yb")
    out = secp256k1_complete_add((xa, ya), (xb, yb))
    _push_point_advice(processor, out)
    _register_ec_claim(
        processor, PID_EC_ADD, ec_point_node(xa, ya), (xb, yb), out
    )


def handle_secp256k1_mul(processor) -> None:
    """``miden::core::crypto::ec::secp256k1::mul``: read a 256-bit
    scalar and an affine point, push R = [k]·P onto the advice stack,
    and register the EC mul claim. Reference analog: the MSM host ops
    behind precompiles-prover/src/ec/msm/."""
    from ..vm.deferred import PID_EC_MUL, secp256k1_scalar_mul, u256_value_node

    k = _read_u256_limbs(processor, 1, "scalar")
    xp = _read_u256_limbs(processor, 9, "xp")
    yp = _read_u256_limbs(processor, 17, "yp")
    out = secp256k1_scalar_mul(k, (xp, yp))
    _push_point_advice(processor, out)
    _register_ec_claim(
        processor, PID_EC_MUL, u256_value_node(k), (xp, yp), out
    )


def handle_ecdsa_commit(processor) -> None:
    """``miden::core::crypto::dsa::ecdsa_secp256k1::commit``: read
    ``[e, r, s, qx, qy]`` (8 LE u32 limbs each) at the pointer on the
    stack and push the ECDSA commitment point R' = [e·s⁻¹]G + [r·s⁻¹]Q
    onto the advice stack. When no commitment exists (out-of-range or
    degenerate signature) the generator is pushed as a benign fallback —
    the in-VM checks of ``verify_prehash`` then evaluate to false.
    Host analog of the reference's recovery ops
    (precompiles/src/ + dsa masm wrappers)."""
    from ..dsa.ecdsa_k256 import GX, GY
    from ..dsa.ecdsa_k256 import N as EC_N
    from ..vm.deferred import (
        secp256k1_complete_add,
        secp256k1_scalar_mul,
    )

    ptr = int(processor.stack[1])
    vals = []
    for j in range(5):
        limbs = []
        for i in range(8):
            addr = ptr + 8 * j + i
            word = processor.memory.get(
                (processor.ctx, addr - addr % 4), (0, 0, 0, 0)
            )
            v = int(word[addr % 4])
            if v > U32_MAX:
                raise ExecutionError("ecdsa commit: memory limb not u32")
            limbs.append(v)
        vals.append(sum(v << (32 * i) for i, v in enumerate(limbs)))
    e, r, s, qx, qy = vals
    pt = None
    if 0 < r < EC_N and 0 < s < EC_N:
        w = pow(s, -1, EC_N)
        pt = secp256k1_complete_add(
            secp256k1_scalar_mul(e * w % EC_N, (GX, GY)),
            secp256k1_scalar_mul(r * w % EC_N, (qx, qy)),
        )
    if pt is None or pt == (0, 0):
        pt = (GX, GY)
    _push_point_advice(processor, pt)


def handle_aead_decrypt(processor) -> None:
    """``miden::core::crypto::aead::decrypt`` (aead.masm): read the
    ciphertext blocks at src_ptr, decrypt + authenticate host-side
    (crypto/aead.py AeadPoseidon2), and push the padded plaintext onto
    the advice stack; raises ExecutionError when the tag is invalid.
    The masm side re-encrypts the advice in-VM and asserts the tag, so
    malicious advice cannot forge a decryption under proving."""
    from ..crypto.aead import AeadError, AeadPoseidon2, EncryptedData, _pad

    s = processor.stack
    key = [int(s[1 + i]) for i in range(4)]
    nonce = tuple(int(s[5 + i]) for i in range(4))
    tag = tuple(int(s[9 + i]) for i in range(4))
    src, n = int(s[13]), int(s[15])
    if n > 1 << 16:
        raise ExecutionError("aead::decrypt: block count exceeds budget")
    ct = []
    for i in range(8 * n):
        addr = src + i
        word = processor.memory.get(
            (processor.ctx, addr - addr % 4), (0, 0, 0, 0)
        )
        ct.append(int(word[addr % 4]))
    try:
        plain = AeadPoseidon2(key).decrypt_elements(
            EncryptedData("elements", ct, tag, nonce)
        )
    except AeadError as exc:
        raise ExecutionError(f"aead::decrypt: {exc}") from exc
    processor.advice.stack[0:0] = _pad(plain)


def _debug_print(line: str) -> None:
    import sys

    print(line, file=sys.stderr)


def handle_debug_print_stack(processor) -> None:
    """``miden::core::debug::print_stack`` (debug.masm): print the full
    operand stack, top first (the event id at s[0] is elided)."""
    vals = [int(v) for v in processor.stack[1:]]
    _debug_print(f"[debug] stack (depth {processor.depth}): {vals}")


def handle_debug_print_mem(processor) -> None:
    """``miden::core::debug::print_mem``: print words covering
    ``[start, end)`` of the current context (start at s[1])."""
    start, end = int(processor.stack[1]), int(processor.stack[2])
    if end < start or end - start > 1 << 16:
        raise ExecutionError("debug::print_mem: invalid range")
    for addr in range(start - start % 4, end, 4):
        word = processor.memory.get((processor.ctx, addr), None)
        if word is not None:
            _debug_print(f"[debug] mem[{addr}..{addr + 4}] = {list(word)}")


def handle_debug_print_mem_all(processor) -> None:
    """``miden::core::debug::print_mem_all``: print every initialized
    word of the current context, address-ordered."""
    for (ctx, addr), word in sorted(processor.memory.items()):
        if ctx == processor.ctx:
            _debug_print(f"[debug] mem[{addr}..{addr + 4}] = {list(word)}")


def handle_debug_print_adv_stack(processor) -> None:
    """``miden::core::debug::print_adv_stack``: print the first n
    advice-stack elements (all when n = 0; n at s[1])."""
    n = int(processor.stack[1])
    vals = [int(v) for v in processor.advice.stack]
    if n:
        vals = vals[:n]
    _debug_print(f"[debug] advice stack: {vals}")


def stdlib_event_handlers() -> dict[int, object]:
    """Event-id -> handler map to pass as ``event_handlers=`` to execute /
    prove_program."""
    return {
        event_id("miden::core::math::u64::u64_div"): handle_u64_div,
        event_id(
            "miden::core::crypto::hashes::keccak256::merge"
        ): handle_keccak_merge,
        event_id(
            "miden::core::crypto::hashes::keccak256::hash_memory"
        ): handle_keccak_hash_memory,
        event_id(
            "miden::core::crypto::ec::secp256k1::add"
        ): handle_secp256k1_add,
        event_id(
            "miden::core::crypto::ec::secp256k1::mul"
        ): handle_secp256k1_mul,
        event_id(
            "miden::core::crypto::dsa::ecdsa_secp256k1::commit"
        ): handle_ecdsa_commit,
        event_id("miden::core::crypto::aead::decrypt"): handle_aead_decrypt,
        event_id("miden::core::debug::print_stack"): handle_debug_print_stack,
        event_id("miden::core::debug::print_mem"): handle_debug_print_mem,
        event_id(
            "miden::core::debug::print_mem_all"
        ): handle_debug_print_mem_all,
        event_id(
            "miden::core::debug::print_adv_stack"
        ): handle_debug_print_adv_stack,
    }


def handle_keccak_hash_memory(processor) -> None:
    """``miden::core::crypto::hashes::keccak256::hash_memory``: read the
    message from memory (canonical chunk layout: 40 u32 limbs per
    136-byte block, zero-padded — vm/deferred.py keccak_message_chunks),
    validate the layout, push the keccak256 digest limbs onto the
    advice stack (d7 first), and register the arbitrary-length claim in
    the deferred DAG."""
    from ..hash.keccak_host import keccak256
    from ..vm.deferred import (
        MAX_WIRE_BYTES,
        Node,
        keccak_message_chunks,
        keccak_statement_node,
    )

    s = processor.stack
    ptr, length = int(s[1]), int(s[2])
    # Bound the untrusted length BEFORE the read loop: a hostile program
    # could otherwise stall the host executor with 40*(length//136+1)
    # memory reads; the masm-side u32 check and the precompile decode's
    # wire cap only fire later.
    if length >= MAX_WIRE_BYTES:
        raise ExecutionError(
            f"keccak256::hash_memory: length {length} exceeds the "
            f"deferred wire budget ({MAX_WIRE_BYTES})"
        )
    n_blocks = length // 136 + 1
    limbs = []
    for i in range(40 * n_blocks):
        addr = ptr + i
        word = processor.memory.get(
            (processor.ctx, addr - addr % 4), (0, 0, 0, 0)
        )
        v = int(word[addr % 4])
        if v > U32_MAX:
            raise ExecutionError(
                "keccak256::hash_memory: memory limb not u32"
            )
        limbs.append(v)
    data = b"".join(v.to_bytes(4, "little") for v in limbs)
    message = bytearray()
    for j in range(n_blocks):
        message += data[160 * j : 160 * j + 136]
    if any(message[length:]):
        raise ExecutionError(
            "keccak256::hash_memory: nonzero bytes beyond the message"
        )
    message = bytes(message[:length])
    want = [
        v for chunk in keccak_message_chunks(message) for v in chunk
    ]
    if limbs != want:
        raise ExecutionError(
            "keccak256::hash_memory: non-canonical chunk layout"
        )

    digest = keccak256(message)
    out = int.from_bytes(digest, "little")
    dlimbs = [(out >> (32 * i)) & U32_MAX for i in range(8)]
    processor.advice.stack[0:0] = list(reversed(dlimbs))

    out_node = Node.chunks_from_bytes(digest)
    _register(processor, out_node)
    msg_node, stmt = keccak_statement_node(message, out_node.digest())
    _register(processor, msg_node)
    _register(processor, stmt)


def smt_advice(smt, keys, advice=None):
    """Installs the advice (Merkle paths + leaf preimages) for
    ``collections::smt`` reads of ``keys`` against the host ``Smt``
    (merkle/smt.py). Returns the AdviceProvider."""
    from ..merkle.nodes import NodeIndex
    from ..merkle.smt import SMT_DEPTH, smt_leaf_index
    from ..vm.processor import AdviceProvider

    adv = advice or AdviceProvider()
    for key in keys:
        k = tuple(int(v) for v in key)
        index = smt_leaf_index(k)
        proof = smt.open(k)
        leaf_hash = proof.leaf.hash()
        adv.store.add_merkle_path(index, leaf_hash, proof.path)
        if proof.leaf.entries:
            adv.map[tuple(leaf_hash)] = [
                int(x) for ek, ev in proof.leaf.entries for x in (*ek, *ev)
            ]
    return adv
