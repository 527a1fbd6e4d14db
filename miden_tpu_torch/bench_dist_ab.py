"""One side of ``bench_dist --parent``: ``prove_sharded`` of a VM program on
gloo ranks sharing the card, with the package of another checkout.

    BENCH_DIST_ROOT=<checkout> python3 <this file> <program source> <ranks>

Run by path, not as a module: it imports ``miden_tpu_torch`` from
``BENCH_DIST_ROOT`` (this checkout's or an earlier one's) and uses only what
both have (``dist.prover.prove_sharded``, ``vm.prove.vm_statement``). It
builds that checkout's kernels, proves on the ranks (each one timed, with
its peak allocated memory and its bytes of the STARK proof) and prints one
JSON line: a list, one entry a rank.
"""

import hashlib
import json
import os
import sys
import time

if os.environ.get("BENCH_DIST_ROOT"):  # also read by the spawned ranks, which import this file again
    sys.path.insert(0, os.environ["BENCH_DIST_ROOT"])


def rank_main(rank: int, src: str) -> dict:
    import torch

    from miden_tpu_torch.dist import make_mesh
    from miden_tpu_torch.dist.prover import prove_sharded
    from miden_tpu_torch.stark import MIDEN_PARAMS
    from miden_tpu_torch.stark.proof_io import proof_to_bytes
    from miden_tpu_torch.transcript.challenger import DuplexChallenger
    from miden_tpu_torch.utils import cuda
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.prove import protocol_seed, vm_statement
    from miden_tpu_torch.vm.trace import execute_and_trace

    cuda.load_built()
    mesh = make_mesh("cuda")
    _, trace = execute_and_trace(assemble(src))
    statement = vm_statement(trace.program_hash, trace.stack_inputs, trace.stack_outputs,
                             trace.kernel_digests, trace.deferred_root)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = prove_sharded(MIDEN_PARAMS, statement, [trace.matrix, trace.chiplets, trace.poseidon],
                        DuplexChallenger(protocol_seed()), mesh)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated(),
            "sha256": hashlib.sha256(proof_to_bytes(res.proof)).hexdigest(), "traffic": dict(mesh.traffic)}


def main() -> int:
    import torch

    from miden_tpu_torch import native
    from miden_tpu_torch.dist.mesh import run_ranks
    from miden_tpu_torch.utils import cuda

    src, ranks = sys.argv[1], int(sys.argv[2])
    cuda.build_all()
    native.trace_gen_lib()
    torch.cuda.empty_cache()
    print(json.dumps(run_ranks(ranks, rank_main, (src,), backend="gloo", threads=2)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
