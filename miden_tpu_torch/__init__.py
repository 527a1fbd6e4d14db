"""miden_tpu_torch: the lifted-STARK prover of ``miden_tpu`` in PyTorch.

A port of the JAX package to one NVIDIA H100: the Goldilocks field as int64
tensors, batched Poseidon2, radix-2 NTT/LDE, lifted Merkle commitments, a
device-resident Fiat-Shamir challenger and the prover/verifier. The TPU's
Pallas kernels are hand-written CUDA kernels here (``csrc/``), built with
``nvcc`` at first use; every kernel has a plain torch twin that the CPU
path runs.

Entry points: :func:`miden_tpu_torch.vm.prove.prove_program` and
:func:`miden_tpu_torch.vm.prove.verify_program` (execute a MASM program on
the host, prove its trace, verify the proof), over the lower-level
:func:`miden_tpu_torch.stark.prove` / :func:`miden_tpu_torch.stark.verify`
and :func:`miden_tpu_torch.bench_airs.miden_shaped_statement`. They run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``.

The package imports neither ``jax`` nor ``miden_tpu``.
"""
