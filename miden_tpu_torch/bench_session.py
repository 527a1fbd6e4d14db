"""Deferred-session workloads: the pinned sessions and the stdlib program.

Shared by ``chip_smoke.py`` (phase 6) and ``tests/test_torch_precompile_prove.py``
so each constant lives in one place.

- ``U256_SESSION``: two u256 add claims and one mul claim; its proof at
  ``TEST_PARAMS`` is byte-equal to ``miden_tpu``'s.
- ``MIXED_SESSION``: one claim of every kind (u256 add and mul, a 64-byte
  keccak merge, a 200-byte keccak, an EC add, an EC mul with a small
  scalar), so every session AIR is present.
- ``MIXED_SESSION_KECCAK``, ``MIXED_SESSION_EC``: its two halves that
  ``miden_tpu``'s verifier can check.
- ``PINNED``: the SHA-256 of each session's ``MTPU`` proof bytes at
  ``TEST_PARAMS``; the card must give the same bytes. Only U256_SESSION's
  digest is of reference bytes (``miden_tpu``'s CPU proof, and the port's).
  The three MIXED digests were minted on the card, as a CPU proof of them
  takes hours: they are determinism checks, which the verifiers' acceptance
  of the proofs (``tests/test_torch_precompile_card.py``) and chip_smoke's
  card-vs-CPU check of the keccak and EC AIRs' aux traces and quotients
  back up.
- :func:`stdlib_session_program`: one MASM program that verifies ECDSA
  signatures in the VM, hashes 1 KiB messages with ``keccak256::hash_memory``
  and walks a Merkle-style path of ``keccak256::merge`` calls — the path
  every stdlib keccak or ECDSA user takes to full verification.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time

from .dsa.ecdsa_k256 import SigningKey, _point_mul
from .hash.keccak_host import keccak256
from .vm.deferred import keccak_message_chunks

U256_SESSION = (
    ("u256_add", (1 << 255) + 12345, (1 << 255) + (7 << 128)),
    ("u256_add", 0xDEADBEEF, (1 << 200) - 1),
    ("u256_mul", (1 << 128) + 3, (1 << 130) + 5),
)
MIXED_SESSION = (
    ("u256_add", 7, 9),
    ("u256_mul", 0xDEADBEEF_CAFEBABE, (1 << 200) + 17),
    ("kmerge", 0x1122_DEAD_BEEF, (1 << 255) | 0xF00D),
    ("keccak", bytes(range(200))),
    ("ec_add", "G", "2G"),
    ("ec_mul", 0b1011_0110_1001, "G"),
)

#: MIXED_SESSION without its EC claims, and without its arbitrary-length
#: keccak claim: ``miden_tpu``'s session AIRs reject a session that mixes
#: the two (its claim count leaves out n_ec), so these two halves are what
#: its verifier can accept of the port's proofs of the new AIRs
MIXED_SESSION_KECCAK = tuple(c for c in MIXED_SESSION if not c[0].startswith("ec_"))
MIXED_SESSION_EC = tuple(c for c in MIXED_SESSION if c[0] != "keccak")

#: SHA-256 of ``proof_to_bytes(prove_deferred_state(claims(S), TEST_PARAMS).stark)``
PINNED = {
    "U256_SESSION": "cdce5e5e11a3575b1dceb1f0676ad2551aa8dd7ecc348791b087beeb10b04255",
    "MIXED_SESSION": "d0e59ac81e8cc5d6af1a2072d7eb42092324cbc3793b5de0f5aa07a1fd71f9df",
    "MIXED_SESSION_KECCAK": "25379fbfcc33db8eb4131d9295a743c3160298f4231f6d5c451a9cde0b708896",
    "MIXED_SESSION_EC": "218d4b6c9a83662f9b45de5953d301a295229466c83a534024c416398cc72c12",
}


def claims(spec) -> list:
    """The port's claim objects of a session spec."""
    from .precompile import EcAddClaim, EcMulClaim, Keccak256Claim, KeccakClaim, U256AddClaim, U256MulClaim

    points = {"G": _point_mul(1), "2G": _point_mul(2)}
    out = []
    for kind, *args in spec:
        args = [points.get(a, a) if isinstance(a, str) else a for a in args]
        if kind == "keccak":
            out.append(KeccakClaim(message=args[0]))
            continue
        cls = {"u256_add": U256AddClaim, "u256_mul": U256MulClaim, "kmerge": Keccak256Claim,
               "ec_add": EcAddClaim, "ec_mul": EcMulClaim}[kind]
        out.append(cls(a=args[0], b=args[1]))
    return out


def proof_digest(deferred_proof) -> str:
    """SHA-256 (hex) of a session proof's ``MTPU`` bytes."""
    from .stark.proof_io import proof_to_bytes

    return hashlib.sha256(proof_to_bytes(deferred_proof.stark)).hexdigest()


# ---------------------------------------------------------------------------
# The stdlib program
# ---------------------------------------------------------------------------


def _limbs256(x: int) -> list:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _push8(limbs) -> str:
    return (f"push.{limbs[7]}.{limbs[6]}.{limbs[5]}.{limbs[4]} "
            f"push.{limbs[3]}.{limbs[2]}.{limbs[1]}.{limbs[0]}")


def _store_words(limbs, addr: int) -> str:
    """Stores u32 limbs from ``addr`` on, a word (4 limbs) at a time."""
    out = []
    for i in range(0, len(limbs), 4):
        w = list(limbs[i : i + 4]) + [0] * (4 - len(limbs[i : i + 4]))
        if any(w):
            out.append(f"push.{w[3]}.{w[2]}.{w[1]}.{w[0]} push.{addr + i} mem_storew_le dropw")
    return " ".join(out)


N_ECDSA = 8  # in-VM ECDSA verifications: 3 EC mul and 1 EC add claims each
N_MESSAGES, MESSAGE_BYTES = 8, 1024  # keccak256::hash_memory calls, 8 blocks each
N_MERGES = 32  # depth of the keccak256::merge path
PROGRAM_SEED = b"miden-tpu-torch-session"  # keys, signatures, messages, path
ECDSA_BASE = 1000  # verification j reads its 40 limbs at ECDSA_BASE + 64·j
MESSAGE_BASE = 1 << 16  # message j at MESSAGE_BASE + 512·j (1 KiB = 320 limbs)


def stdlib_session_program():
    """(source, expected top 8 limbs): ``N_ECDSA`` in-VM ECDSA verifications
    (``ecdsa_secp256k1::verify_prehash``, each asserted valid),
    ``N_MESSAGES`` × ``keccak256::hash_memory`` of ``MESSAGE_BYTES``-byte
    messages (digests dropped), and an ``N_MERGES``-deep path of
    ``keccak256::merge`` over 64-byte nodes, whose root the program leaves
    on top of the stack. Keys, signatures and messages derive from
    ``PROGRAM_SEED``."""
    seed = PROGRAM_SEED
    body = []
    for j in range(N_ECDSA):
        sk = SigningKey.from_seed(seed + b"/ecdsa/%d" % j)
        pk = sk.public_key()
        digest = hashlib.sha256(seed + b"/digest/%d" % j).digest()
        sig = sk.sign_prehash(digest)
        assert pk.verify_prehash(digest, sig)
        base = ECDSA_BASE + 64 * j
        for k, v in enumerate((int.from_bytes(digest, "big"), sig.r, sig.s, pk.x, pk.y)):
            body.append(_store_words(_limbs256(v), base + 8 * k))
        body.append(f"push.{base} exec.ecdsa_secp256k1::verify_prehash assert")
    for j in range(N_MESSAGES):
        msg = hashlib.shake_256(seed + b"/message/%d" % j).digest(MESSAGE_BYTES)
        limbs = [v for c in keccak_message_chunks(msg) for v in c]
        ptr = MESSAGE_BASE + 512 * j
        body.append(_store_words(limbs, ptr))
        body.append(f"push.{len(msg)} push.{ptr} exec.keccak256::hash_memory dropw dropw")
    node = int.from_bytes(hashlib.sha256(seed + b"/leaf").digest(), "little")
    body.append(_push8(_limbs256(node)))
    for j in range(N_MERGES):
        sib = int.from_bytes(hashlib.sha256(seed + b"/sibling/%d" % j).digest(), "little")
        body.append(_push8(_limbs256(sib)) + " exec.keccak256::merge")
        node = int.from_bytes(keccak256(sib.to_bytes(32, "little") + node.to_bytes(32, "little")), "little")
    body.append("swapdw dropw dropw")  # the root on top, depth back to 16
    source = (
        "use miden::core::crypto::dsa::ecdsa_secp256k1\n"
        "use miden::core::crypto::hashes::keccak256\n"
        "begin " + " ".join(b for b in body if b) + " end"
    )
    return source, _limbs256(node)


# ---------------------------------------------------------------------------
# What comes before a session proof: python3 -m miden_tpu_torch.bench_session
# ---------------------------------------------------------------------------


def _launch_us(torch) -> float:
    """Host microseconds per launch of a one-element CUDA add, over 20000."""
    x = torch.zeros(1, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20000):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 20000 * 1e6


def main() -> int:
    """Times ``prove_deferred_state_dag`` of the stdlib program's session on
    one card, in one process, after each thing chip_smoke runs before its
    timed session proofs: (A) right after the main proof, untraced;
    (B) traced (spans synchronize at their edges); (C) untraced after a
    traced call; (D) untraced after a VM fib-18 ``prove_program`` and one
    more under ``torch.profiler``, as phase 5b runs them. Each call prints
    its wall and process CPU seconds and the allocator's cudaMalloc retries
    and new segments; the host's launch cost is measured at the start and
    after (D)'s profiler."""
    import subprocess

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .precompile import session as S
    from .stark import MIDEN_PARAMS
    from .stdlib import assemble_with_stdlib, stdlib_event_handlers
    from .utils import cuda
    from .utils.tracing import Recorder
    from .vm import assemble
    from .vm.prove import prove_program

    if not torch.cuda.is_available():
        raise SystemExit("bench_session: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; host {os.cpu_count()} CPUs", flush=True)
    cuda.build_all()
    print(f"host launch cost at the start: {_launch_us(torch):.2f} us", flush=True)
    src, _ = stdlib_session_program()
    out, _ = prove_program(assemble_with_stdlib(src), params=MIDEN_PARAMS,
                           event_handlers=stdlib_event_handlers(), device="cuda")

    def session(label, traced=False):
        stats0 = torch.cuda.memory_stats()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(Recorder()) if traced else None
            S.prove_deferred_state_dag(out.deferred_state, MIDEN_PARAMS, device="cuda")
            torch.cuda.synchronize()
        wall, cpu = time.perf_counter() - t0, time.process_time() - c0
        stats = torch.cuda.memory_stats()
        print(f"  {label}: {wall:.4f} s wall, {cpu:.4f} s process CPU, "
              f"{stats['num_alloc_retries'] - stats0['num_alloc_retries']} alloc retries, "
              f"{stats['segment.all.allocated'] - stats0['segment.all.allocated']} new segments, "
              f"reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB", flush=True)
        if rec is not None:
            print("    spans: " + "; ".join(f"{k} {v[0]:.4f} s" for k, v in rec.totals.items()), flush=True)

    for rep in range(2):
        session(f"A{rep} untraced, right after the main proof")
    session("B traced", traced=True)
    for rep in range(2):
        session(f"C{rep} untraced, after a traced call")
    fib = assemble("begin push.0 push.1 repeat.84000 swap dup.1 add end swap drop swap drop end")
    # eager (fused=False): the launches the profiler sees are the host's
    prove_program(fib, params=MIDEN_PARAMS, device="cuda", fused=False)
    with profile(activities=[ProfilerActivity.CUDA]):
        prove_program(fib, params=MIDEN_PARAMS, device="cuda", fused=False)
        torch.cuda.synchronize()
    print(f"host launch cost after the profiler: {_launch_us(torch):.2f} us", flush=True)
    for rep in range(2):
        session(f"D{rep} untraced, after a VM fib-18 proof and a profiled one")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
