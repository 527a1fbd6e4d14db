"""The port stands alone: it imports neither JAX nor the JAX package.

``import miden_tpu_torch`` (and its public entry points) in a fresh
interpreter must leave ``jax`` and ``miden_tpu`` out of ``sys.modules``, and
no source file of the port or ``chip_smoke.py`` may import them.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "miden_tpu_torch"


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize(
    "stmt",
    [
        "import miden_tpu_torch",
        "from miden_tpu_torch.stark import prove, verify",
        "from miden_tpu_torch.bench_airs import miden_shaped_statement",
        "import miden_tpu_torch.stark.proof_io, miden_tpu_torch.transcript.device_challenger",
        "from miden_tpu_torch.vm.prove import VmProof, prove_program, verify_program, protocol_seed",
        "from miden_tpu_torch.vm import assemble, execute; from miden_tpu_torch.vm.trace import execute_and_trace",
        "from miden_tpu_torch.vm.constraints.aux_numeric import build_device_aux",
        "from miden_tpu_torch.merkle import MerkleStore, MerkleTree, Smt, Mmr; import miden_tpu_torch.native",
        "from miden_tpu_torch.precompile.session import prove_deferred_state_dag, verify_deferred; "
        "from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers; "
        "from miden_tpu_torch.dsa.ecdsa_k256 import SigningKey; import miden_tpu_torch.bench_session",
        "from miden_tpu_torch.stark.debug import check_air; from miden_tpu_torch.vm.constraints import check_core_trace",
        "from miden_tpu_torch.hash.rescue import RPO, RPX; from miden_tpu_torch.hash import rescue_host",
        "from miden_tpu_torch.stark.preprocessed import build_preprocessed; "
        "from miden_tpu_torch.bench_airs import square_lut_statement",
        "import miden_tpu_torch.cli; from miden_tpu_torch.vm.mast_io import program_from_bytes; "
        "from miden_tpu_torch.vm.package import MastPackage; from miden_tpu_torch.vm.resume import execute_stepwise",
        "from miden_tpu_torch.hash import blake3, keccak, sha2, stateful; "
        "from miden_tpu_torch.merkle.lmcs import BLAKE3_HASH, KECCAK_HASH",
        "import miden_tpu_torch.crypto; from miden_tpu_torch.crypto import aead, ecdh, ies, rand_coin; "
        "from miden_tpu_torch.stdlib import smt_advice, stdlib_modules",
        "from miden_tpu_torch.stdlib.recursion import extract_recursion_fixture; "
        "import miden_tpu_torch.bench_recursion; from miden_tpu_torch.dsa import ed25519, falcon512",
        "from miden_tpu_torch.dist import make_mesh, use_mesh; from miden_tpu_torch.dist.prover import prove_sharded",
        "from miden_tpu_torch.stark.fused import prove_fused, use_fused",
    ],
)
def test_import_pulls_in_neither_jax_nor_miden_tpu(stmt):
    code = (
        f"import sys; {stmt}; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'miden_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_miden_tpu(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "miden_tpu"), f"{path.name} imports {name}"


def test_source_text_has_no_jax_import_lines():
    for path in _sources():
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), f"{path}: {s}"
            if s.startswith(("import miden_tpu", "from miden_tpu")):
                assert s.split()[1].split(".")[0] == "miden_tpu_torch", f"{path}: {s}"
