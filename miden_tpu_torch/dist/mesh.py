"""Process groups, the row mesh and its collectives (``miden_tpu/dist/mesh.py``).

``miden_tpu`` shards the trace-row axis over a ``jax.sharding.Mesh`` of
devices in one process. Here each rank is a process of a
``torch.distributed`` group holding one device, and a :class:`Mesh` names
that group, this rank's place in it and its device. A row-sharded matrix is
a :class:`RowShard`: this rank's contiguous block of rows ``[k·S, (k+1)·S)``
and the matrix's whole height.

Two backends, chosen by the group's backend name and nothing else:

- ``nccl``: CUDA tensors move card to card;
- ``gloo``: the tensors move through host memory (gloo's point-to-point
  takes CPU tensors), whether the mesh's device is the CPU or a card that
  several ranks share.

Groups start from a ``FileStore`` in a temporary directory
(:func:`init_group`, :func:`run_ranks`): no port and no network.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

ROWS = "rows"  # the one mesh axis, named as miden_tpu names it

#: seconds a collective may wait for the other ranks before it fails
TIMEOUT_S = 900


@dataclass
class Mesh:
    """A 1-D mesh over the ranks of ``group``: rank ``rank`` of ``size``
    holds rows ``[rank·S, (rank+1)·S)`` of every sharded matrix, on
    ``device``. ``traffic`` counts the bytes this rank sent in exchanges
    and received in gathers."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = ROWS
    traffic: dict = field(default_factory=lambda: {"exchange": 0, "gather": 0})

    def global_rank(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)


@dataclass(frozen=True)
class RowShard:
    """Rows ``[k·S, (k+1)·S)`` of a ``(rows, ...)`` matrix on mesh rank k;
    the other blocks lie on the other ranks."""

    local: torch.Tensor
    rows: int

    @property
    def shape(self) -> tuple:
        return (self.rows, *self.local.shape[1:])


def init_group(backend: str, rank: int, world: int, store_dir: str) -> None:
    """Join the default process group over a ``FileStore`` in ``store_dir``.
    An NCCL rank takes card ``rank mod count``."""
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    opts = {}
    if backend == "nccl":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        opts["device_id"] = card
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world, timeout=timedelta(seconds=TIMEOUT_S), **opts
    )


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh over ``group`` (default: the default group) on ``device``.

    A CUDA mesh puts each rank on its local card (``rank mod count``); over
    gloo several ranks may share one card. Without an initialized default
    group this starts one of a single rank: NCCL for ``cuda``, gloo for
    ``cpu``. Without a card, ``make_mesh("cuda")`` raises: the CPU is
    taken only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' for a mesh of CPU ranks)")
    if not dist.is_initialized():
        init_group("nccl" if device.type == "cuda" else "gloo", 0, 1, tempfile.mkdtemp(prefix="mesh"))
    group = group if group is not None else dist.group.WORLD
    backend = dist.get_backend(group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: an NCCL group needs device='cuda'")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), device, backend)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> RowShard:
    """This rank's contiguous block of the rows of ``x`` (which every rank
    holds whole), on the mesh's device."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_rows: {n} rows over {mesh.size} ranks")
    s = n // mesh.size
    return RowShard(x[mesh.rank * s : (mesh.rank + 1) * s].to(mesh.device).contiguous(), n)


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (a broadcast; ``x`` has the same shape
    and dtype on every rank and is left as it is)."""
    buf = x.detach().to("cpu" if mesh.backend == "gloo" else mesh.device).clone()
    dist.broadcast(buf, src=mesh.global_rank(0), group=mesh.group)
    return buf.to(mesh.device)


def exchange(x: torch.Tensor, peer: int, mesh: Mesh) -> torch.Tensor:
    """Send ``x`` to mesh rank ``peer`` and receive its tensor of the same
    shape: one send and one receive, into a fresh buffer."""
    send = x.contiguous()
    if mesh.backend == "gloo":
        send = send.cpu()
    recv = torch.empty_like(send)
    p = mesh.global_rank(peer)
    ops = [dist.P2POp(dist.isend, send, p, mesh.group), dist.P2POp(dist.irecv, recv, p, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    mesh.traffic["exchange"] += send.numel() * send.element_size()
    return recv.to(mesh.device)


def gather_rows(x, mesh: Mesh) -> torch.Tensor:
    """The whole matrix of a :class:`RowShard` (every rank's block, in
    rank order) on every rank; a tensor is already whole."""
    if not isinstance(x, RowShard):
        return x
    local = x.local.contiguous()
    if mesh.backend == "gloo":
        src = local.cpu()
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(parts, src, group=mesh.group)
        whole = torch.cat(parts).to(mesh.device)
    else:
        whole = torch.empty((x.rows, *local.shape[1:]), dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(whole, local, group=mesh.group)
    mesh.traffic["gather"] += (mesh.size - 1) * local.numel() * local.element_size()
    return whole


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, world, backend, store_dir, threads):
    torch.set_num_threads(threads)
    with open(os.path.join(store_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    init_group(backend, rank, world, store_dir)
    try:
        out = fn(rank, *args)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, args=(), backend: str = "gloo", threads: int = 1) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes that form one
    default group of ``backend``; return their results in rank order. A
    rank that raises makes this raise (the other ranks are stopped).
    ``fn`` must be importable by name, and its arguments and results
    picklable. The call goes through a file: arguments larger than a pipe's
    buffer in the spawn arguments would start the processes one by one."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks") as store_dir:
        with open(os.path.join(store_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        mp.start_processes(
            _rank_main, args=(world, backend, store_dir, threads), nprocs=world, start_method="spawn"
        )
        out = []
        for rank in range(world):
            with open(os.path.join(store_dir, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
