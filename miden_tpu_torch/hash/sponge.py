"""The three entries of a width-12 Goldilocks permutation on torch tensors.

Every permutation of the port (K3 Poseidon2, R1 RPO-256, R2 RPX-256) offers
the same three entries, each a hand-written kernel (``csrc/sponge_rows.cuh``
over the permutation) for CUDA tensors and a plain torch twin for CPU
tensors; nothing but the tensor's device chooses between them:

- ``permute``: ``(12, n)`` int64 states, one permutation per column;
- ``absorb_rows``: the LMCS leaf sponge over one row-major matrix, in
  overwrite mode (rate lanes 0..8, capacity 8..12), with cyclic lifting and
  a zero-padded tail block;
- ``compress_rows``: one Merkle layer over row-major digests,
  ``(2m, 4) → (m, 4)``, the state ``[left, right, 0, 0, 0, 0]`` truncated to
  its first 4 lanes.

``hash_blocks`` and ``compress_pairs`` are the sponge and the 2-to-1
compression in the layout of ``miden_tpu.hash.poseidon2`` /
``miden_tpu.hash.rescue``.
"""

from __future__ import annotations

import torch

from ..utils import cuda

RATE = 8


class Sponge:
    """One permutation's entries. ``lib`` is the kernel library
    (``csrc/<lib>.cu``), whose launchers are ``<name>_permute``,
    ``<name>_absorb_rows`` and ``<name>_compress_rows``, launching the
    kernels of ``csrc/sponge_rows.cuh`` over the permutation ``perm`` (the
    struct's name); ``permute_plain`` is the plain torch permutation on
    ``(12, n)`` states (any device)."""

    def __init__(self, name: str, lib: str, perm: str, permute_plain):
        self.name = name
        self.permute_plain = permute_plain
        self.PERMUTE_KERNEL = cuda.Kernel(
            lib, f"{name}_permute", [cuda.P, cuda.P, cuda.I64, cuda.P], "permute_kernel", perm
        )
        #: the leaf sponge over a row-major matrix (one launch per committed matrix)
        self.ABSORB_KERNEL = cuda.Kernel(
            lib, f"{name}_absorb_rows",
            [cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.I64, cuda.P], "absorb_rows_kernel", perm,
        )
        #: one Merkle layer over row-major digests
        self.COMPRESS_KERNEL = cuda.Kernel(
            lib, f"{name}_compress_rows", [cuda.P, cuda.P, cuda.I64, cuda.P], "compress_rows_kernel", perm
        )

    # -- permute ---------------------------------------------------------------

    def permute_kernel(self, state: torch.Tensor) -> torch.Tensor:
        """The kernel on a CUDA ``(12, n)`` int64 state; any n ≥ 1."""
        cuda.check_tensor(state, f"{self.name} state")
        if state.ndim != 2 or state.shape[0] != 12 or state.shape[1] < 1:
            raise ValueError(f"{self.name} state: expected (12, n >= 1), got {tuple(state.shape)}")
        out = torch.empty_like(state)
        self.PERMUTE_KERNEL.launch(
            state.data_ptr(), out.data_ptr(), state.shape[1], key=(state.shape[1],)
        )
        return out

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """The permutation on a batch of states, shape ``(12, n)``."""
        if state.is_cuda:
            return self.permute_kernel(state.contiguous())
        return self.permute_plain(state)

    # -- absorb_rows -------------------------------------------------------------

    def absorb_rows_plain(self, state: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """Plain twin of :meth:`absorb_rows`: one permutation per rate-8
        column block of ``m``, each block lifted to ``max_h`` rows and the
        ragged tail block zero-padded."""
        h, w = m.shape
        reps = state.shape[1] // h
        for c0 in range(0, w, RATE):
            chunk = m[:, c0 : c0 + RATE].T  # (≤ 8, h)
            if chunk.shape[0] < RATE:
                pad = torch.zeros((RATE - chunk.shape[0], h), dtype=torch.int64, device=m.device)
                chunk = torch.cat([chunk, pad])
            if reps > 1:
                chunk = chunk.repeat(1, reps)
            state = self.permute_plain(torch.cat([chunk, state[8:]]))
        return state

    def absorb_rows_kernel(self, state: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """The leaf-sponge kernel on CUDA tensors: state ``(12, max_h)``,
        ``m`` an ``(h, w)`` row-major matrix, h a power of two dividing max_h."""
        cuda.check_tensor(state, "sponge state")
        cuda.check_tensor(m, "absorbed matrix")
        if state.ndim != 2 or state.shape[0] != 12 or state.shape[1] < 1 or m.ndim != 2:
            raise ValueError(
                f"absorb_rows: expected state (12, max_h) and m (h, w), got "
                f"{tuple(state.shape)} and {tuple(m.shape)}"
            )
        max_h = state.shape[1]
        h, w = m.shape
        if h < 1 or h & (h - 1) or max_h % h or w >= 1 << 31:
            raise ValueError(f"absorb_rows: height {h} must be a power of two dividing {max_h}")
        if w == 0:
            return state
        out = torch.empty_like(state)
        self.ABSORB_KERNEL.launch(
            state.data_ptr(), out.data_ptr(), m.data_ptr(), h, w, max_h, key=(max_h, h, w)
        )
        return out

    def absorb_rows(self, state: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """Absorb every row-major row of ``m`` (h, w) into the overwrite-mode
        sponge states ``(12, max_h)``: state ``d`` takes row ``d mod h``, rate 8."""
        if state.is_cuda:
            return self.absorb_rows_kernel(state.contiguous(), m.contiguous())
        return self.absorb_rows_plain(state, m)

    # -- compress_rows -----------------------------------------------------------

    def compress_rows_plain(self, cur: torch.Tensor) -> torch.Tensor:
        """Plain twin of :meth:`compress_rows`: the states [row 2i, row 2i + 1,
        0, 0, 0, 0] permuted and truncated to their first 4 lanes."""
        m = cur.shape[0] // 2
        zeros = torch.zeros((4, m), dtype=torch.int64, device=cur.device)
        out = self.permute_plain(torch.cat([cur.reshape(m, 8).T, zeros]))
        return out[:4].T.contiguous()

    def compress_rows_kernel(self, cur: torch.Tensor) -> torch.Tensor:
        """The Merkle-layer kernel on a CUDA ``(2m, 4)`` tensor, 16-byte aligned."""
        cuda.check_tensor(cur, "digest layer")
        if cur.ndim != 2 or cur.shape[1] != 4 or cur.shape[0] < 2 or cur.shape[0] % 2:
            raise ValueError(f"compress_rows: expected (2m, 4) with m >= 1, got {tuple(cur.shape)}")
        if cur.data_ptr() % 16:
            raise ValueError("compress_rows: the digest layer must be 16-byte aligned")
        m = cur.shape[0] // 2
        out = torch.empty((m, 4), dtype=torch.int64, device=cur.device)
        self.COMPRESS_KERNEL.launch(cur.data_ptr(), out.data_ptr(), m, key=(m,))
        return out

    def compress_rows(self, cur: torch.Tensor) -> torch.Tensor:
        """One Merkle layer: rows ``2i`` and ``2i + 1`` of ``cur`` (2m, 4)
        compress to row ``i`` of the result (m, 4)."""
        if cur.is_cuda:
            return self.compress_rows_kernel(cur.contiguous())
        return self.compress_rows_plain(cur)

    # -- the miden_tpu layout ------------------------------------------------------

    def hash_blocks(self, blocks: torch.Tensor) -> torch.Tensor:
        """Overwrite-mode sponge over rate-8 blocks: ``(n, n_blocks, 8)`` →
        digests ``(n, 4)``."""
        n, n_blocks, rate = blocks.shape
        assert rate == RATE
        state = torch.zeros((12, n), dtype=torch.int64, device=blocks.device)
        state = self.absorb_rows(state, blocks.reshape(n, n_blocks * rate))
        return state[:4].T.contiguous()

    def compress_pairs(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """Truncated-permutation 2-to-1 compression: ``(n, 4) × (n, 4) → (n, 4)``."""
        return self.compress_rows(torch.stack([left, right], dim=1).reshape(-1, 4))
